"""The lambda sweep (``ops/sweep``, ``cli/find_lambda``) against the JAX
package, on one seeded graph and one seeded pair of tables.

- Both flavors under x64 (f64 G, A and W_gen; the f32 grid of
  ``find_lambda``): at every grid point the two packages' lists are
  identical, and so are the 5-decimal rows of ``sweep_rows``. The unrounded
  metric rows are f32 in both packages (the JAX metric ops cast to float32
  under x64 too), summed in another order: P, R, NDCG and H within 1e-6
  relative (measured: 1.1e-7), I, a difference of two sums of U k^2 f32
  terms, within 1e-5 (measured: 1.3e-6).
- The tall flavor equals the dense one within ``tests/test_sweep.py``'s
  1e-4 relative; a sweep row equals the port's per-lambda
  ``fused_recommend`` plus ``evaluate_recommendations`` (P, R, NDCG, H
  equal; I and F1 within 1e-4: the S-gather form of I@k sums in another
  order than the evaluation's bilinear form).
- ``find_lambda`` on shared checkpoints: the CSV byte-identical to the JAX
  CLI's on the dense flavor, the tall flavor and the blocked regime the
  W-free flavor takes (``DENSE_TRANSFER_BUDGET_BYTES`` shrunk in both
  packages, as ``tests/test_sweep.py`` shrinks it); the exit where no
  single-device layout fits (JAX's "run with --mesh" exit); a mesh shape
  with no process group to run it on.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lgcnhs_tpu.ops.diffusion as jdiff
from lgcnhs_tpu.cli import find_lambda as j_fl
from lgcnhs_tpu.ops import sweep as jsweep
from lgcnhs_tpu.ops.topk import rank_exclude_seen_topk as j_rank
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import find_lambda as t_fl
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.eval.metrics import EvalContext, evaluate_recommendations
from lgcnhs_tpu_torch.models import lightgcn as tlgcn
from lgcnhs_tpu_torch.models.fusion import allocate_matrix, fused_recommend
from lgcnhs_tpu_torch.models.recommenders import checkpoint_path
from lgcnhs_tpu_torch.ops import diffusion as tdiff
from lgcnhs_tpu_torch.ops import metrics_ops as tmet
from lgcnhs_tpu_torch.ops import sweep as tsweep
from lgcnhs_tpu_torch.ops.topk import rank_exclude_seen_topk as t_rank
from lgcnhs_tpu_torch.train import trainer as ttrainer

U, I, D, K = 48, 90, 16, 5
GRID = np.arange(0.0, 1.0 + 0.1, 0.1, dtype=np.float32)


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


def _setup(dtype):
    """Host arrays of one seeded graph: G (masked layer-0 scores of seeded
    tables), A, W_gen, seen, the eval arrays, S, item degrees. The last 4
    items have no train/val interaction (zero degree)."""
    rng = np.random.default_rng(3)
    edges = [tgraph.EdgeSet(rng.integers(0, U, n).astype(np.int32),
                            np.minimum(rng.integers(0, I, n), I - 5).astype(np.int32))
             for n in (700, 120, 150)]
    train, val, test = edges
    ctx = EvalContext.build(U, I, test, train, val)
    A = tgraph.interaction_matrix(U, I, train, val, dtype=dtype)
    seen = tgraph.pos_bool_matrix(U, I, train, val)
    params = tlgcn.LightGCNParams(torch.from_numpy(rng.standard_normal((U, D)).astype(dtype)),
                                  torch.from_numpy(rng.standard_normal((I, D)).astype(dtype)))
    G = allocate_matrix(params, torch.from_numpy(seen)).numpy()
    W_gen = tdiff.general_spreading_matrix(torch.from_numpy(A)).numpy()
    S = tmet.similarity_matrix(torch.from_numpy(ctx.interaction),
                               torch.from_numpy(ctx.item_deg)).numpy()
    return {"G": G, "A": A, "W_gen": W_gen, "seen": seen, "eval_pos": ctx.eval_pos,
            "eval_counts": ctx.eval_counts, "eval_present": ctx.eval_present, "S": S,
            "item_deg": ctx.item_deg, "params": params, "ctx": ctx}


DENSE_ARGS = ("G", "A", "W_gen", "seen", "eval_pos", "eval_counts", "eval_present", "S")
TALL_ARGS = ("G", "A", "seen", "eval_pos", "eval_counts", "eval_present", "item_deg")


def _lists(s, flavor):
    """Per grid point, each package's (U, K) list of the sweep's ranking."""
    out = []
    A_j, A_t = jnp.asarray(s["A"]), torch.from_numpy(s["A"])
    for lam in GRID:
        if flavor == "dense":
            k_item = s["A"].sum(axis=0)
            F_j = jnp.dot(A_j, jsweep._blended_transfer(jnp.asarray(s["W_gen"]),
                                                         jnp.asarray(k_item), jnp.float32(lam)),
                          precision=jax.lax.Precision.HIGHEST)
            F_t = tdiff.hybrid_resource(A_t, torch.from_numpy(s["W_gen"]), torch.tensor(lam))
        else:
            F_j = jdiff.user_factored_diffusion_scores(A_j, jnp.float32(lam))
            F_t = tdiff.user_factored_diffusion_scores(A_t, torch.tensor(lam))
        out.append((np.asarray(j_rank(jnp.asarray(s["G"]) * F_j, jnp.asarray(s["seen"]), K)),
                    t_rank(torch.from_numpy(s["G"]) * F_t, torch.from_numpy(s["seen"]),
                           K).numpy()))
    return out


@pytest.mark.parametrize("flavor", ["dense", "tall"])
def test_sweep_matches_jax_under_x64(x64, flavor):
    s = _setup(np.float64)
    names = DENSE_ARGS if flavor == "dense" else TALL_ARGS
    j_fn, t_fn = ((jsweep.lambda_sweep_metrics, tsweep.lambda_sweep_metrics)
                  if flavor == "dense" else
                  (jsweep.lambda_sweep_metrics_tall, tsweep.lambda_sweep_metrics_tall))
    want = np.asarray(j_fn(jnp.asarray(GRID), *(jnp.asarray(s[n]) for n in names), K))
    got = t_fn(GRID, *(torch.from_numpy(s[n]) for n in names), K).numpy()
    assert got.shape == want.shape == (len(GRID), len(tsweep.METRIC_COLUMNS))
    for j_rec, t_rec in _lists(s, flavor):
        np.testing.assert_array_equal(t_rec, j_rec)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=1e-6, atol=0)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=1e-5, atol=0)
    assert tsweep.sweep_rows(GRID, got) == jsweep.sweep_rows(GRID, want)


def test_hybrid_transfer_forms_one_minus_lambda_in_the_grid_dtype(x64):
    """An f32 lambda over f64 A and W_gen: 1 - l rounds in f32 first, as in
    the JAX sweep's ``_blended_transfer``."""
    s = _setup(np.float64)
    A, W_gen = torch.from_numpy(s["A"]), torch.from_numpy(s["W_gen"])
    lam = np.float32(0.01)
    want = np.asarray(jsweep._blended_transfer(jnp.asarray(s["W_gen"]),
                                               jnp.asarray(s["A"].sum(axis=0)),
                                               jnp.float32(lam)))
    got = tdiff.hybrid_transfer(A, W_gen, torch.tensor(lam)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    exact = tdiff.hybrid_transfer(A, W_gen, float(lam)).numpy()
    assert not np.array_equal(exact, got)  # f64(1 - l) is another exponent


def test_tall_sweep_equals_dense_sweep():
    s = _setup(np.float32)
    dense = tsweep.lambda_sweep_metrics(GRID, *(torch.from_numpy(s[n]) for n in DENSE_ARGS), K)
    tall = tsweep.lambda_sweep_metrics_tall(GRID, *(torch.from_numpy(s[n]) for n in TALL_ARGS),
                                            K)
    np.testing.assert_allclose(tall.numpy(), dense.numpy(), rtol=1e-4, atol=1e-5)


def test_sweep_row_equals_per_lambda_recommendation():
    s = _setup(np.float32)
    lambdas = np.asarray([0.0, 0.3, 0.5, 0.85, 1.0], np.float32)
    rows = tsweep.sweep_rows(lambdas, tsweep.lambda_sweep_metrics(
        lambdas, *(torch.from_numpy(s[n]) for n in DENSE_ARGS), K).numpy())
    A, seen = torch.from_numpy(s["A"]), torch.from_numpy(s["seen"])
    for lam, row in zip(lambdas, rows):
        rec = fused_recommend(s["params"], A, seen, torch.tensor(lam), K).numpy()
        want = evaluate_recommendations(s["ctx"], rec)
        for key in ("P", "R", "NDCG", "H"):
            assert row[key] == want[key], (lam, key, row, want)
        assert abs(row["I"] - want["I"]) < 1e-4 and abs(row["F1"] - want["F1"]) < 1e-4


# -- cli/find_lambda -------------------------------------------------------------------------


def _size(users, items, interactions):
    return ["--dataset", "synthetic", "--env", "dev", "--users", str(users), "--items",
            str(items), "--interactions", str(interactions), "--epochs", "4",
            "--model", "SpreadLightGCNOpti"]


def _write_checkpoint(workdirs, users, items, interactions):
    """One seeded LightGCNOpti checkpoint in every workdir, where both
    CLIs look for it."""
    over = {"synthetic_users": users, "synthetic_items": items,
            "synthetic_interactions": interactions}
    cfgs = [tcfg.load_config(dataset="synthetic", model="SpreadLightGCNOpti", workdir=w,
                             overrides=over) for w in workdirs]
    _, uf, itf = load_dataset(cfgs[0])
    params = tlgcn.init_lightgcn_opti(torch.Generator().manual_seed(5), uf, itf, D)
    for cfg in cfgs:
        os.makedirs(cfg.model_path, exist_ok=True)
        ttrainer.save_checkpoint(checkpoint_path(cfg), params)
    return cfgs


@pytest.mark.parametrize("case", [
    ("dense", (50, 80, 2000), None),
    # dense over budget (2 I^2 + 3 U I), the factored live set within it
    ("tall", (30, 70, 900), 30_000),
    # the blocked regime (2U >= I) whose factored live set still fits
    ("tall", (60, 70, 1200), 70_000),
], ids=["dense", "tall", "blocked-to-tall"])
def test_find_lambda_csv_is_byte_identical_to_jax(tmp_path, monkeypatch, case):
    flavor, size, budget = case
    if budget is not None:
        monkeypatch.setattr(jdiff, "DENSE_TRANSFER_BUDGET_BYTES", budget)
        monkeypatch.setattr(tdiff, "DENSE_TRANSFER_BUDGET_BYTES", budget)
    calls = []
    for name in ("lambda_sweep_metrics", "lambda_sweep_metrics_tall"):
        real = getattr(t_fl, name)
        monkeypatch.setattr(t_fl, name, lambda *a, _f=real, _n=name, **kw:
                            calls.append(_n) or _f(*a, **kw))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jcfg, tcfg_ = _write_checkpoint([jdir, tdir], *size)
    j_fl.main(_size(*size) + ["--workdir", jdir, "--step", "0.25"])
    rows = t_fl.main(_size(*size) + ["--workdir", tdir, "--step", "0.25", "--device", "cpu"])
    assert calls == ["lambda_sweep_metrics" + ("_tall" if flavor == "tall" else "")]
    assert [r["lambda"] for r in rows] == [0.0, 0.25, 0.5, 0.75, 1.0]
    name = f"lambda_evaluation_{tcfg_.k}.csv"
    with open(os.path.join(jcfg.evaluation_path, name), "rb") as f:
        want = f.read()
    with open(os.path.join(tcfg_.evaluation_path, name), "rb") as f:
        got = f.read()
    assert got == want


def test_find_lambda_needs_a_mesh_where_nothing_fits(tmp_path, monkeypatch):
    monkeypatch.setattr(tdiff, "DENSE_TRANSFER_BUDGET_BYTES", 1)
    trained = []
    monkeypatch.setattr(t_fl, "get_or_train_params", lambda *a, **kw: trained.append(1))
    with pytest.raises(SystemExit, match="run with --mesh to use the item-sharded sweep"):
        t_fl.main(_size(60, 70, 900) + ["--workdir", str(tmp_path), "--step", "0.5",
                                        "--device", "cpu"])
    assert not trained  # the flavor is picked before G is trained or loaded


def test_find_lambda_mesh_raises_with_roadmap_pointer(tmp_path, monkeypatch):
    real = t_fl.config_from_args

    def with_mesh(args):
        cfg = real(args)
        return cfg.replace(compute=cfg.compute.__class__(mesh_shape=(2, 1)))

    monkeypatch.setattr(t_fl, "config_from_args", with_mesh)
    # a (2, 1) mesh needs two ranks: without a launcher the run stops, naming it
    with pytest.raises(ValueError, match="no process group is running.*torchrun"):
        t_fl.main(_size(50, 80, 2000) + ["--workdir", str(tmp_path), "--device", "cpu"])

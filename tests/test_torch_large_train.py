"""Large-graph training and retrieval against the JAX package:
``train_lightgcn`` through the COO (bucketed-ELL) route, the bf16-dense
rung and the kernel route with the CSR evaluation, and ``recommend_gcn``'s
chunked branch.

The routes are forced as ``tests/test_propagation_paths.py`` forces them:
``compute.dense_threshold=1.0`` for COO, and shrunken
``DENSIFY_BUDGET_BYTES`` / ``HOST_INCIDENCE_BUILD_BYTES`` on both trainers
for the rung and the CSR evaluation. Both packages get the injected tables
and triple stream of ``tests/test_torch_train_run.py``, here through the
CSR samplers (``ops/scalable.sample_*_csr``).

Tolerances: histories within 1e-5 (equal to 5 decimals but for a rounding
boundary). Tables: COO under x64 within 1e-7 of scale (the edge weights are
f32 in both packages, and XLA's f32 rsqrt may sit one f32 step from the
port's correctly rounded one: ~6e-8 relative on a weight); COO at f32
within 1e-5 (f32 sums in another order); the rung within 1e-4 of scale:
its bf16 layer inputs are rounded at the same places in both, but an f32
sum in another order can round one bf16 step (2^-8) apart, which moves
that element's Adam updates (measured: one element 1.75e-5 of scale apart
after 9 epochs).
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train_run import _inject, _stream  # noqa: E402

import lgcnhs_tpu.models.recommenders as jrec
from lgcnhs_tpu.config import load_config as j_load_config
from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.models.lightgcn import LightGCNParams as JParams
from lgcnhs_tpu.ops import scalable as jscalable
from lgcnhs_tpu.train import trainer as jtrainer
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import retrieve as t_retrieve
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.models import recommenders as trec
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams as TParams
from lgcnhs_tpu_torch.ops.topk import masked_topk
from lgcnhs_tpu_torch.train import trainer as ttrainer

U, I, D, SEED = 50, 70, 12, 42
EPOCHS, EVAL_EVERY, BATCH, K = 9, 3, 32, 5


def _graph_pair(seed=11):
    rng = np.random.default_rng(seed)
    tu, ti = rng.integers(0, U, 600).astype(np.int32), rng.integers(0, I, 600).astype(np.int32)
    vu, vi = rng.integers(0, U, 90).astype(np.int32), rng.integers(0, I, 90).astype(np.int32)
    return [mod.InteractionGraph(U, I, mod.EdgeSet(np.r_[tu, vu], np.r_[ti, vi]),
                                 mod.EdgeSet(tu, ti), mod.EdgeSet(vu, vi),
                                 mod.EdgeSet(tu[:0], ti[:0])) for mod in (jgraph, tgraph)]


def _inject_csr(monkeypatch, graph, dtype):
    """The injected tables and stream of ``_inject``; the CSR samplers of
    both packages read the same stream (the JAX trainer imports them from
    ``ops/scalable`` when it builds a step)."""
    train_es, val_es = tgraph.unique_edges(graph.train), tgraph.unique_edges(graph.val)
    tab, val_negs = _stream(train_es, val_es, I, EPOCHS, EVAL_EVERY, BATCH, 12)
    rng = np.random.default_rng(13)
    ue0 = (0.1 * rng.standard_normal((U, D))).astype(dtype)
    ie0 = (0.1 * rng.standard_normal((I, D))).astype(dtype)
    _inject(monkeypatch, SEED, EPOCHS, tab, val_negs, val_es, ue0, ie0)
    monkeypatch.setattr(jscalable, "sample_bpr_batch_csr",
                        lambda key, eu, ei, rowptr, cols, batch_size, n_items, n_retries=8:
                        jtrainer.sample_bpr_batch(key, eu, ei, None, batch_size, n_items))
    monkeypatch.setattr(jscalable, "sample_negatives_for_edges_csr",
                        lambda key, eu, ei, rowptr, cols, n_items, n_retries=8,
                        reject_user_ids=False:
                        jtrainer.sample_negatives_for_edges(key, eu, ei, None, n_items))
    monkeypatch.setattr(ttrainer, "sample_bpr_batch_csr",
                        lambda gen, eu, ei, keys, batch_size, n_items:
                        ttrainer.sample_bpr_batch(gen, eu, ei, None, batch_size, n_items))
    monkeypatch.setattr(ttrainer, "sample_negatives_for_edges_csr",
                        lambda gen, eu, ei, keys, n_items, reject_user_ids=False:
                        ttrainer.sample_negatives_for_edges(gen, eu, ei, None, n_items))


def _overrides(dtype, **extra):
    return {"hparams.seed": SEED, "hparams.embedding_dim": D, "hparams.lr": 1e-2,
            "hparams.gamma": 0.9, "hparams.epochs": EPOCHS,
            "hparams.epoch_per_eval": EVAL_EVERY, "hparams.epoch_per_lr_decay": 2,
            "hparams.batch_size": BATCH, "hparams.epsilon": 1e-4, "k": K,
            "compute.dtype": dtype, **extra}


def _train_both(graphs, over, x64=False):
    j_cfg = j_load_config(dataset="synthetic", model="LightGCN", overrides=over)
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", x64)
    try:
        want = jtrainer.train_lightgcn(graphs[0], j_cfg, save_artifacts=False)
    finally:
        jax.config.update("jax_enable_x64", was)
    t_cfg = tcfg.load_config(dataset="synthetic", model="LightGCN", overrides=over)
    got = ttrainer.train_lightgcn(graphs[1], t_cfg, save_artifacts=False, device="cpu")
    return got, want


def _assert_runs_match(got, want, table_tol):
    assert got.history["iters"] == want.history["iters"] == [0, 3, 6]
    for name, col in want.history.items():
        np.testing.assert_allclose(got.history[name], col, rtol=0, atol=1e-5 + 1e-12,
                                   err_msg=name)
    for g, w in zip(got.params, want.params):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=table_tol * np.abs(w).max())


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_coo_route_matches_jax(monkeypatch, dtype):
    """The bucketed-ELL train step, the COO val loss and the CSR evaluation
    in both packages (dense_threshold=1.0 sends the graph to COO)."""
    graphs = _graph_pair()
    _inject_csr(monkeypatch, graphs[1], np.float64 if dtype == "float64" else np.float32)
    routes = []
    monkeypatch.setattr(ttrainer, "make_coo_train_step",
                        lambda *a, _f=ttrainer.make_coo_train_step, **kw:
                        routes.append("coo") or _f(*a, **kw))
    got, want = _train_both(graphs, _overrides(dtype, **{"compute.dense_threshold": 1.0}),
                            x64=dtype == "float64")
    assert routes == ["coo"]
    _assert_runs_match(got, want, 1e-7 if dtype == "float64" else 1e-5)


def test_bf16_rung_matches_jax(monkeypatch):
    """The bf16-dense rung (bf16 incidence built on the device, CSR sampler,
    CSR evaluation) under budgets where the bf16 incidence fits and the f32
    eval arrays do not."""
    graphs = _graph_pair(14)
    _inject_csr(monkeypatch, graphs[1], np.float32)
    for mod in (jtrainer, ttrainer):
        monkeypatch.setattr(mod, "DENSIFY_BUDGET_BYTES", 3.0 * U * I)
        monkeypatch.setattr(mod, "HOST_INCIDENCE_BUILD_BYTES", 0.0)
    built = []
    monkeypatch.setattr(ttrainer, "device_bf16_incidence",
                        lambda *a, _f=ttrainer.device_bf16_incidence:
                        built.append(a[:2]) or _f(*a))
    got, want = _train_both(graphs, _overrides("bfloat16"))
    assert built == [(U, I)]
    _assert_runs_match(got, want, 1e-4)


def test_kernel_route_with_csr_eval_equals_its_dense_eval(monkeypatch):
    """The kernel route (``dual_matmul``'s twin here) past the eval budget:
    CSR sampler and CSR evaluation, no dense (U, I) eval array. Its train
    losses and tables equal the same route's with the dense evaluation
    (the CSR sampler draws the dense triples), its val losses and metrics
    within 1e-5 (another summation order)."""
    _, tg = _graph_pair(15)
    cfg = tcfg.load_config(dataset="synthetic", model="LightGCN", overrides=_overrides(
        "bfloat16", **{"hparams.lr": 1e-3, "hparams.epochs": 12}))
    monkeypatch.setattr(ttrainer, "uses_kernels", lambda compute, device: compute.use_pallas)
    dense_eval = ttrainer.train_lightgcn(tg, cfg, save_artifacts=False, device="cpu")
    monkeypatch.setattr(ttrainer, "DENSIFY_BUDGET_BYTES", 3.0 * U * I)
    for name in ("interaction_matrix", "pos_bool_matrix", "normalized_bipartite"):
        monkeypatch.setattr(ttrainer, name, _no_dense)
    csr_eval = ttrainer.train_lightgcn(tg, cfg, save_artifacts=False, device="cpu")
    assert csr_eval.history["train_loss"] == dense_eval.history["train_loss"]
    for name, col in dense_eval.history.items():
        np.testing.assert_allclose(csr_eval.history[name], col, rtol=0, atol=1e-5 + 1e-12,
                                   err_msg=name)
    for g, w in zip(csr_eval.params, dense_eval.params):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _no_dense(*a, **kw):
    raise AssertionError("a dense (U, I) constructor was called on the large-graph path")


@pytest.mark.parametrize("route", ["coo", "rung"])
def test_large_graph_path_allocates_no_dense_eval_array(monkeypatch, route):
    """Train and recommend on a small graph under shrunken budgets with the
    dense (U, I) constructors of the trainer and the recommender made to
    raise: nothing on the path but the rung's train incidence is (U, I).
    The chunked ``recommend_gcn`` ids equal JAX's ``chunked_masked_topk``
    and dense ``recommend_gcn`` ids on the same tables."""
    cfg = tcfg.load_config(dataset="synthetic", model="LightGCN", overrides={
        "synthetic_users": 120, "synthetic_items": 200, "synthetic_interactions": 4000,
        "hparams.epochs": 4, "hparams.epoch_per_eval": 2, "hparams.batch_size": 64,
        "hparams.embedding_dim": 8, "k": 5,
        "compute.dtype": "float32" if route == "coo" else "bfloat16"})
    splits, _, _ = load_dataset(cfg)
    graph = tgraph.build_graph(splits)
    U_, I_ = graph.n_users, graph.n_items
    monkeypatch.setattr(ttrainer, "DENSIFY_BUDGET_BYTES", 3.0 * U_ * I_)
    monkeypatch.setattr(ttrainer, "HOST_INCIDENCE_BUILD_BYTES", 0.0)
    assert ttrainer.choose_propagation(U_, I_, graph.train.n_edges, cfg.compute) == \
        ("coo" if route == "coo" else "dense")
    for name in ("interaction_matrix", "pos_bool_matrix", "normalized_bipartite"):
        monkeypatch.setattr(ttrainer, name, _no_dense)
    monkeypatch.setattr(trec, "pos_bool_matrix", _no_dense)

    result = ttrainer.train_lightgcn(graph, cfg, save_artifacts=False, device="cpu")
    assert result.history["iters"] == [0, 2]
    assert all(np.isfinite(v) for col in result.history.values() for v in col)
    rec = trec.recommend_gcn(graph, cfg, result.params)
    assert rec.shape == (U_, cfg.k) and rec.dtype == np.int32

    ue, ie = (t.numpy() for t in result.params)
    seen = tgraph.pos_bool_matrix(U_, I_, graph.train, graph.val)
    np.testing.assert_array_equal(
        rec, masked_topk(torch.from_numpy(ue @ ie.T), torch.from_numpy(seen), cfg.k).numpy())
    rowptr, cols = jscalable.user_csr(U_, jgraph.EdgeSet(
        np.r_[graph.train.users, graph.val.users], np.r_[graph.train.items, graph.val.items]))
    j_chunked = jscalable.chunked_masked_topk(jnp.asarray(ue), jnp.asarray(ie), rowptr, cols,
                                              cfg.k, chunk_bytes=64 * 4 * I_)
    j_graph = jgraph.InteractionGraph(U_, I_, *(jgraph.EdgeSet(e.users, e.items) for e in
                                                (graph.all, graph.train, graph.val, graph.test)))
    j_cfg = j_load_config(dataset="synthetic", model="LightGCN", overrides={"k": cfg.k})
    j_dense = jrec.recommend_gcn(j_graph, j_cfg, JParams(jnp.asarray(ue), jnp.asarray(ie)))
    np.testing.assert_array_equal(rec, j_chunked)
    np.testing.assert_array_equal(rec, np.asarray(j_dense))


def test_chunked_recommend_gcn_equals_the_dense_branch(monkeypatch):
    """``recommend_gcn`` past the budget (chunked over users, CSR masks)
    and under it (one dense seen mask) give identical lists."""
    cfg = tcfg.load_config(dataset="synthetic", model="LightGCN", overrides={
        "synthetic_users": 300, "synthetic_items": 150, "synthetic_interactions": 5000, "k": 10})
    splits, _, _ = load_dataset(cfg)
    graph = tgraph.build_graph(splits)
    rng = np.random.default_rng(3)
    params = TParams(torch.from_numpy(rng.standard_normal((graph.n_users, 16)).astype(np.float32)),
                     torch.from_numpy(rng.standard_normal((graph.n_items, 16)).astype(np.float32)))
    want = trec.recommend_gcn(graph, cfg, params)
    chunks = []
    monkeypatch.setattr(ttrainer, "DENSIFY_BUDGET_BYTES", 1.0)
    monkeypatch.setattr(trec, "chunked_masked_topk",
                        lambda *a, _f=trec.chunked_masked_topk, **kw:
                        chunks.append(a[0].shape) or _f(*a, chunk_bytes=4 * 64 * graph.n_items))
    got = trec.recommend_gcn(graph, cfg, params)
    assert chunks == [(graph.n_users, 16)]
    np.testing.assert_array_equal(got, want)


def test_coo_route_learns():
    """The JAX ``test_coo_training_path_runs_and_learns`` graph and run on the
    port's COO route: finite history, falling train loss."""
    cfg = tcfg.load_config(dataset="synthetic", model="LightGCN", overrides={
        "synthetic_users": 50, "synthetic_items": 80, "synthetic_interactions": 2500,
        "hparams.epochs": 40, "hparams.epoch_per_eval": 20, "hparams.batch_size": 128,
        "compute.dense_threshold": 1.0})
    splits, _, _ = load_dataset(cfg)
    result = ttrainer.train_lightgcn(tgraph.build_graph(splits), cfg, save_artifacts=False,
                                     device="cpu")
    losses = result.history["train_loss"]
    assert all(np.isfinite(v) for col in result.history.values() for v in col)
    assert losses[-1] < losses[0]


def test_coo_route_learns_and_serves_through_cli_retrieve(tmp_path):
    """A graph sparser than ``compute.dense_threshold``: ``cli/retrieve`` on
    an empty workdir trains through the bucketed route, writes the
    checkpoint and history, and serves lists that exclude seen items."""
    sparse = ["--dataset", "synthetic", "--env", "dev", "--users", "4000", "--items", "20000",
              "--interactions", "3000", "--k", "10", "--epochs", "41", "--batch-size", "128"]
    rec = t_retrieve.main(["--device", "cpu", "--model", "LightGCN",
                           "--workdir", str(tmp_path), *sparse])
    cfg = tcfg.load_config(dataset="synthetic", model="LightGCN", workdir=str(tmp_path),
                           overrides={"synthetic_users": 4000, "synthetic_items": 20000,
                                      "synthetic_interactions": 3000, "k": 10})
    splits, _, _ = load_dataset(cfg)
    graph = tgraph.build_graph(splits)
    assert ttrainer.choose_propagation(graph.n_users, graph.n_items, graph.train.n_edges,
                                       cfg.compute) == "coo"
    with open(os.path.join(cfg.pictures_path, "LightGCN_10_val_metrics.csv")) as f:
        rows = [line.split(",") for line in f.read().split("\n")[1:] if line]
    assert [int(r[0]) for r in rows] == [0]  # the dev preset evaluates every 200 epochs
    assert all(np.isfinite(float(v)) for v in rows[0])
    seen = tgraph.pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
    assert rec.shape == (graph.n_users, 10)
    assert not seen[np.arange(graph.n_users)[:, None], rec].any()

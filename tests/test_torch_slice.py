"""The serving slice as a whole: ``lgcnhs_tpu.cli.retrieve`` and
``lgcnhs_tpu_torch.cli.retrieve`` on one small synthetic config with one
shared npz checkpoint, for LightGCNOpti (retrieval) and SpreadLightGCNOpti
(fused serving); plus the parameter bridges and the port's import and
device rules.

The two CLIs must write tie-equivalent (U, k) matrices: agreement >= 0.999,
every mismatched slot within 5e-4 relative under an f64 reference.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_checks import tie_equivalence  # noqa: E402

from lgcnhs_tpu.cli import retrieve as j_retrieve
from lgcnhs_tpu.models import lightgcn as jlgcn
from lgcnhs_tpu.train import trainer as jtrainer
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import retrieve as t_retrieve
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.data.graph import build_graph, interaction_matrix, pos_bool_matrix
from lgcnhs_tpu_torch.models import lightgcn as tlgcn
from lgcnhs_tpu_torch.models.recommenders import checkpoint_path
from lgcnhs_tpu_torch.ops.diffusion import general_spreading_matrix, hybrid_transfer
from lgcnhs_tpu_torch.train import trainer as ttrainer

SIZE = ["--dataset", "synthetic", "--env", "dev", "--users", "150",
        "--items", "240", "--interactions", "5000", "--k", "10"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_scores(model, params, graph, lam):
    """(U, I) f64 scores the served lists are read against."""
    ue = params.user_emb.double().numpy()
    ie = params.item_emb.double().numpy()
    seen = pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
    G = ue @ ie.T
    if model == "LightGCNOpti":
        return np.where(seen, -1024.0, G)
    A = torch.from_numpy(interaction_matrix(
        graph.n_users, graph.n_items, graph.train, graph.val, dtype=np.float64))
    W = hybrid_transfer(A, general_spreading_matrix(A), lam)
    return np.where(seen, -3.0e38, G * (A @ W).numpy())


@pytest.mark.parametrize("model", ["LightGCNOpti", "SpreadLightGCNOpti"])
def test_retrieve_cli_matches_jax(model, tmp_path):
    cfg = tcfg.load_config(
        dataset="synthetic", model=model, workdir=str(tmp_path / "t"),
        overrides={"k": 10, "synthetic_users": 150, "synthetic_items": 240,
                   "synthetic_interactions": 5000},
    )
    splits, uf, itf = load_dataset(cfg)
    graph = build_graph(splits)
    params = tlgcn.init_lightgcn_opti(torch.Generator().manual_seed(0), uf, itf, 16)
    for side in ("t", "j"):
        path = checkpoint_path(cfg.replace(workdir=str(tmp_path / side)))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ttrainer.save_checkpoint(path, params)

    want = j_retrieve.main(["--platform", "cpu", "--model", model,
                            "--workdir", str(tmp_path / "j"), *SIZE])
    got = t_retrieve.main(["--device", "cpu", "--model", model,
                           "--workdir", str(tmp_path / "t"), *SIZE])
    saved = np.load(os.path.join(cfg.recommend_path, f"retrieval_{model}_10.npy"))
    np.testing.assert_array_equal(saved, got)
    assert got.shape == want.shape == (graph.n_users, 10)
    ref = _reference_scores(model, params, graph, cfg.hparams.lambda_)
    agreement, gap = tie_equivalence(np.asarray(want), got, ref)
    assert agreement >= 0.999 and gap <= 5e-4, (agreement, gap)


def test_serve_exact_takes_the_plain_chain(tmp_path):
    args = ["--device", "cpu", "--model", "SpreadLightGCNOpti",
            "--workdir", str(tmp_path), *SIZE]
    cfg = tcfg.load_config(dataset="synthetic", model="SpreadLightGCNOpti",
                           workdir=str(tmp_path), overrides={"k": 10})
    splits, uf, itf = load_dataset(cfg.replace(
        synthetic_users=150, synthetic_items=240, synthetic_interactions=5000))
    params = tlgcn.init_lightgcn_opti(torch.Generator().manual_seed(1), uf, itf, 16)
    os.makedirs(cfg.model_path, exist_ok=True)
    ttrainer.save_checkpoint(checkpoint_path(cfg), params)
    np.testing.assert_array_equal(t_retrieve.main(args), t_retrieve.main([*args, "--serve-exact"]))


def test_missing_checkpoint_raises(tmp_path):
    """A missing checkpoint trains first; when training raises, the error
    comes through and nothing is served. Here: ``--neg-range reference`` on
    a graph whose max user id passes the catalog, which both trainers
    refuse (the sparse graph that raised before now trains through the COO
    route, ``tests/test_torch_large_train.py``)."""
    args = ["--dataset", "synthetic", "--env", "dev", "--users", "400", "--items", "100",
            "--interactions", "5000", "--k", "10", "--neg-range", "reference"]
    with pytest.raises(ValueError, match="neg_range='reference'"):
        t_retrieve.main(["--device", "cpu", "--model", "LightGCN",
                         "--workdir", str(tmp_path), *args])
    assert not os.path.exists(tmp_path / "synthetic" / "recommend" / "retrieval_LightGCN_10.npy")


def test_init_lightgcn_opti_with_projection_from_jax_keys():
    rng = np.random.default_rng(2)
    uf = rng.standard_normal((40, 29)).astype(np.float32)
    itf = rng.standard_normal((60, 37)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jlgcn.init_lightgcn_opti(key, jnp.asarray(uf), jnp.asarray(itf), 16)
    k1, k2, k3, k4 = jax.random.split(key, 4)

    def draw(kw, kb, fan_in):
        bound = 1.0 / jnp.sqrt(fan_in)
        return (np.asarray(jax.random.uniform(kw, (fan_in, 16), minval=-bound, maxval=bound)),
                np.asarray(jax.random.uniform(kb, (16,), minval=-bound, maxval=bound)))

    projection = (*draw(k1, k2, 29), *draw(k3, k4, 37))
    got = tlgcn.init_lightgcn_opti(None, uf, itf, 16, projection=projection)
    np.testing.assert_allclose(got.user_emb.numpy(), np.asarray(want.user_emb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.item_emb.numpy(), np.asarray(want.item_emb), rtol=0, atol=1e-6)


def test_seeded_inits_are_reproducible_and_scaled():
    a = tlgcn.init_lightgcn(torch.Generator().manual_seed(3), 500, 300, 64)
    b = tlgcn.init_lightgcn(torch.Generator().manual_seed(3), 500, 300, 64)
    torch.testing.assert_close(a.user_emb, b.user_emb, rtol=0, atol=0)
    assert abs(float(a.user_emb.std()) - 0.1) < 0.005
    uf = np.ones((5, 29), np.float32)
    p = tlgcn.init_lightgcn_opti(torch.Generator().manual_seed(3), uf, uf[:4], 8)
    assert p.user_emb.shape == (5, 8) and p.item_emb.shape == (4, 8)
    assert float(p.user_emb.abs().max()) <= 29 / np.sqrt(29) + 1 / np.sqrt(29)


def test_params_from_jax_and_checkpoints_cross_load(tmp_path):
    jp = jlgcn.init_lightgcn(jax.random.PRNGKey(0), 30, 45, 8)
    tp = tlgcn.params_from_jax(jp.user_emb, jp.item_emb, "cpu")
    assert tp.user_emb.dtype == torch.float32 and tp.user_emb.device.type == "cpu"
    np.testing.assert_array_equal(tp.user_emb.numpy(), np.asarray(jp.user_emb))
    np.testing.assert_array_equal(tp.item_emb.numpy(), np.asarray(jp.item_emb))
    # a JAX-written checkpoint loads in the port, and back
    jtrainer.save_checkpoint(str(tmp_path / "j.npz"), jp)
    loaded = ttrainer.load_checkpoint(str(tmp_path / "j.npz"), "cpu")
    np.testing.assert_array_equal(loaded.item_emb.numpy(), np.asarray(jp.item_emb))
    ttrainer.save_checkpoint(str(tmp_path / "t.npz"), tp)
    back = jtrainer.load_checkpoint(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(back.user_emb), np.asarray(jp.user_emb))
    assert ttrainer.load_checkpoint(str(tmp_path / "absent.npz")) is None


def test_port_imports_no_jax_and_needs_cuda_unless_told(monkeypatch):
    code = ("import sys, lgcnhs_tpu_torch.cli.retrieve; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'lgcnhs_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_retrieve.main(["--model", "LightGCN", "--workdir", "unused", *SIZE])

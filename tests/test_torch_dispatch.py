"""Which path the port's serving entry points take, and float64 tables.

``ops/topk.retrieval_route`` and ``models/fusion.serve_route`` are pure
functions of the device type and the tables' dtype (and, for serving, the
``--serve-exact`` switch), so the CUDA routes are pinned here without a
card: float64 tables (a float64 checkpoint) go to the plain chain at their
own dtype, as the JAX ``retrieve_topk`` sends f64 to its HIGHEST chain;
every other dtype on CUDA goes to a kernel, whose wrapper takes float32
and raises on the rest.

Float64 parity: the port's ``cli/retrieve`` on an f64 checkpoint gives ids
identical to the JAX package's under x64, for LightGCNOpti
(``retrieve_topk``) and SpreadLightGCNOpti (``serve_fused``).
"""
import os

import jax
import numpy as np
import pytest
import torch

from lgcnhs_tpu.cli import retrieve as j_retrieve
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import retrieve as t_retrieve
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.data.graph import build_graph
from lgcnhs_tpu_torch.models import lightgcn as tlgcn
from lgcnhs_tpu_torch.models.fusion import serve_route
from lgcnhs_tpu_torch.models.recommenders import checkpoint_path
from lgcnhs_tpu_torch.ops.topk import retrieval_route
from lgcnhs_tpu_torch.train import trainer as ttrainer

SIZE = ["--dataset", "synthetic", "--env", "dev", "--users", "150",
        "--items", "240", "--interactions", "5000", "--k", "10"]


@pytest.mark.parametrize("device,dtype,route", [
    ("cuda", torch.float64, "plain"),
    ("cuda", torch.bfloat16, "kernel"),
    ("cuda", torch.float32, "kernel"),
    ("cpu", torch.float32, "plain"),
    ("cpu", torch.float64, "plain"),
])
def test_retrieval_route(device, dtype, route):
    assert retrieval_route(device, dtype) == route


@pytest.mark.parametrize("device,dtype,exact,route", [
    ("cuda", torch.float64, False, "plain"),
    ("cuda", torch.float32, False, "kernel"),
    ("cuda", torch.bfloat16, False, "kernel"),
    ("cuda", torch.float32, True, "plain"),
    ("cpu", torch.float32, False, "plain"),
    ("cpu", torch.float64, False, "plain"),
])
def test_serve_route(device, dtype, exact, route):
    assert serve_route(device, dtype, exact) == route


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


@pytest.mark.parametrize("model", ["LightGCNOpti", "SpreadLightGCNOpti"])
def test_float64_checkpoint_serves_as_jax_x64(model, tmp_path, x64):
    """One f64 checkpoint (continuous seeded tables) through both CLIs:
    identical ids, the port at f64 as the JAX package under x64."""
    cfg = tcfg.load_config(
        dataset="synthetic", model=model, workdir=str(tmp_path / "t"),
        overrides={"k": 10, "synthetic_users": 150, "synthetic_items": 240,
                   "synthetic_interactions": 5000},
    )
    splits, _, _ = load_dataset(cfg)
    graph = build_graph(splits)
    rng = np.random.default_rng(5)
    params = tlgcn.LightGCNParams(
        torch.from_numpy(rng.standard_normal((graph.n_users, 16)) * 0.3),
        torch.from_numpy(rng.standard_normal((graph.n_items, 16)) * 0.3),
    )
    assert params.user_emb.dtype == torch.float64
    for side in ("t", "j"):
        path = checkpoint_path(cfg.replace(workdir=str(tmp_path / side)))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ttrainer.save_checkpoint(path, params)
    assert ttrainer.load_checkpoint(checkpoint_path(cfg)).user_emb.dtype == torch.float64

    want = j_retrieve.main(["--platform", "cpu", "--model", model,
                            "--workdir", str(tmp_path / "j"), *SIZE])
    got = t_retrieve.main(["--device", "cpu", "--model", model,
                           "--workdir", str(tmp_path / "t"), *SIZE])
    assert got.shape == (graph.n_users, 10)
    np.testing.assert_array_equal(got, np.asarray(want))

"""The trainer's multi-epoch programs in the port (``train/trainer``
``make_train_scan``, ``make_coo_train_scan``, ``TrainScan`` and the chunk
loop of ``_train_epochs``) on the CPU, where a scan is the loop of the step.

- A scan of 5 epochs from epoch 2 equals five calls of the step from epoch
  2, bitwise (tables, Adam's moments and step, the last loss), on the dense
  f32 route, the kernel route's factored int8 incidence through the twin,
  the CSR sampler and the bucketed COO route: the port's
  ``tests/test_trainer.py::test_train_scan_matches_per_step_path``.
- ``train_lightgcn`` with ``compute.scan_chunk`` 0, 1, 3 and 5 equals the
  run of one eager step an epoch (``trainer.CUDA_GRAPHS`` off) bitwise,
  tables and history, and calls the scan with JAX's chunk lengths: the
  port's ``tests/test_trainer.py::test_scan_chunk_is_invisible_to_training``.
- Through the chunked loop at ``scan_chunk=3``, the injected-stream run of
  ``tests/test_torch_train_run.py`` matches JAX's ``train_lightgcn`` at the
  same ``scan_chunk``, within that file's tolerances: at f64 an identical
  history and tables within 1e-10; at f32 the history within 2e-5 and the
  tables within 1e-5.
- ``--scan-chunk 7`` gives ``compute.scan_chunk == 7`` in both packages'
  ``cli/common``.
- A run resumed from a checkpoint in the middle of an eval interval equals
  the uninterrupted run bitwise (one CPU thread, as
  ``tests/test_torch_resume.py`` runs).
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train_run import _inject, _stream  # noqa: E402

from lgcnhs_tpu.cli import common as j_common
from lgcnhs_tpu.config import load_config as j_load_config
from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.train import trainer as jtrainer
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import common as t_common
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, init_lightgcn
from lgcnhs_tpu_torch.ops.propagation import build_bucketed_incidence, edge_gcn_norm
from lgcnhs_tpu_torch.ops.scalable import csr_keys, user_csr
from lgcnhs_tpu_torch.train import checkpoint as tckpt
from lgcnhs_tpu_torch.train import trainer as ttrainer

U, I, D = 50, 70, 12


@pytest.fixture(autouse=True)
def one_thread():
    """Bitwise reruns need one CPU thread (``tests/test_torch_resume.py``)."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _graph_pair(seed=11):
    rng = np.random.default_rng(seed)
    tu, ti = rng.integers(0, U, 600).astype(np.int32), rng.integers(0, I, 600).astype(np.int32)
    vu, vi = rng.integers(0, U, 90).astype(np.int32), rng.integers(0, I, 90).astype(np.int32)
    return [mod.InteractionGraph(U, I, mod.EdgeSet(np.r_[tu, vu], np.r_[ti, vi]),
                                 mod.EdgeSet(tu, ti), mod.EdgeSet(vu, vi),
                                 mod.EdgeSet(tu[:0], ti[:0])) for mod in (jgraph, tgraph)]


def _cfg(epochs, dtype="float32", **over):
    return tcfg.load_config(dataset="synthetic", model="LightGCN", overrides={
        "hparams.epochs": epochs, "hparams.epoch_per_eval": 4, "hparams.batch_size": 32,
        "hparams.embedding_dim": D, "hparams.lr": 1e-2, "hparams.epoch_per_lr_decay": 3,
        "hparams.gamma": 0.9, "k": 5, "compute.dtype": dtype, **over})


def _route_args(route, graph):
    """(scan builder, step builder, step_rest) of one route on ``graph``."""
    es = tgraph.unique_edges(graph.train)
    eu = torch.from_numpy(es.users.astype(np.int64))
    ei = torch.from_numpy(es.items.astype(np.int64))
    keys = csr_keys(*user_csr(U, es), "cpu")
    pos = torch.from_numpy(tgraph.pos_bool_matrix(U, I, graph.train))
    if route == "coo":
        binc = build_bucketed_incidence(es.users, es.items,
                                        edge_gcn_norm(eu, ei, U, I).numpy(), U, I)
        return ttrainer.make_coo_train_scan, ttrainer.make_coo_train_step, {}, \
            (binc, eu, ei, keys)
    if route == "kernel-twin":
        factors = ttrainer.device_binary_factors(U, I, graph.train, "cpu")
        return ttrainer.make_train_scan, ttrainer.make_train_step, \
            {"bf16_matmul": True, "use_kernel": True}, (factors, eu, ei, pos)
    R = torch.from_numpy(tgraph.normalized_bipartite(U, I, graph.train))
    if route == "csr-sampler":
        return ttrainer.make_train_scan, ttrainer.make_train_step, {"csr_sampler": True}, \
            (R, eu, ei, keys)
    return ttrainer.make_train_scan, ttrainer.make_train_step, {}, (R, eu, ei, pos)


@pytest.mark.parametrize("route", ["dense", "kernel-twin", "csr-sampler", "coo"])
def test_train_scan_matches_per_step_path(route):
    _, tg = _graph_pair()
    hp = _cfg(10).hparams
    make_scan, make_step, kw, rest = _route_args(route, tg)
    seed = 5
    runs = []
    for via_scan in (True, False):
        params = init_lightgcn(torch.Generator().manual_seed(3), U, I, D)
        params = LightGCNParams(*(t.requires_grad_(True) for t in params))
        opt = ttrainer.make_optimizer(hp, params)
        if via_scan:
            loss = make_scan(opt, hp, I, **kw)(params, seed, 2, 5, *rest)
        else:
            step = make_step(opt, hp, I, **kw)
            for e in range(2, 7):
                loss = step(params, e, ttrainer.epoch_generator(seed, e, "cpu"), *rest)
        runs.append((params, tckpt.optimizer_state(opt, params), loss))
    (p_scan, s_scan, l_scan), (p_step, s_step, l_step) = runs
    assert torch.equal(l_scan, l_step)
    for a, b in zip(p_scan, p_step):
        assert torch.equal(a, b)
    for name in s_scan:
        for m, v in s_scan[name].items():
            assert torch.equal(v, s_step[name][m]), (name, m)
    assert float(s_scan["user_emb"]["step"]) == 5.0


def _chunks_of(last_epoch, eval_every, sub):
    """JAX's chunk loop: the scan calls (epoch0, n) of a run of
    ``last_epoch + 1`` epochs with no checkpoint."""
    calls, epoch = [], 0
    while epoch <= last_epoch:
        b = epoch
        while b < last_epoch and b % eval_every:
            b += 1
        if b > epoch:
            n = sub or b + 1 - epoch
            calls += [(e0, min(n, b + 1 - e0)) for e0 in range(epoch, b + 1, n)]
        epoch = b + 1
    return calls


@pytest.mark.parametrize("scan_chunk", [0, 1, 3, 5])
def test_scan_chunk_is_invisible_to_training(monkeypatch, scan_chunk):
    _, tg = _graph_pair()
    calls = []
    real_call = ttrainer.TrainScan.__call__

    def spy(self, params, seed, epoch0, n_steps, *rest):
        calls.append((epoch0, n_steps))
        return real_call(self, params, seed, epoch0, n_steps, *rest)

    monkeypatch.setattr(ttrainer.TrainScan, "__call__", spy)
    got = ttrainer.train_lightgcn(tg, _cfg(14, **{"compute.scan_chunk": scan_chunk}),
                                  save_artifacts=False, device="cpu")
    assert calls == _chunks_of(13, 4, scan_chunk)
    assert calls[0] == (1, 4 if scan_chunk in (0, 5) else min(scan_chunk, 4))
    monkeypatch.setattr(ttrainer, "CUDA_GRAPHS", False)
    calls.clear()
    want = ttrainer.train_lightgcn(tg, _cfg(14), save_artifacts=False, device="cpu")
    assert calls == []
    assert got.history == want.history
    assert got.history["iters"] == [0, 4, 8, 12]
    for a, b in zip(got.params, want.params):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_injected_run_through_chunks_matches_jax(monkeypatch, dtype):
    """9 epochs, evals at 0/4/8 (chunks 1-4 and 5-8 of 3 + 1 epochs at
    ``scan_chunk=3``), lr decays every 2 epochs."""
    seed, epochs, eval_every, batch = 42, 9, 4, 32
    jg, tg = _graph_pair(13)
    train_es, val_es = tgraph.unique_edges(tg.train), tgraph.unique_edges(tg.val)
    tab, val_negs = _stream(train_es, val_es, I, epochs, eval_every, batch, 12)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    rng = np.random.default_rng(7)
    ue0 = (0.1 * rng.standard_normal((U, D))).astype(np_dtype)
    ie0 = (0.1 * rng.standard_normal((I, D))).astype(np_dtype)
    _inject(monkeypatch, seed, epochs, tab, val_negs, val_es, ue0, ie0)
    over = {"hparams.seed": seed, "hparams.embedding_dim": D, "hparams.lr": 1e-2,
            "hparams.gamma": 0.9, "hparams.epochs": epochs,
            "hparams.epoch_per_eval": eval_every, "hparams.epoch_per_lr_decay": 2,
            "hparams.batch_size": batch, "hparams.epsilon": 1e-4, "k": 5,
            "compute.dtype": dtype, "compute.scan_chunk": 3}
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        want = jtrainer.train_lightgcn(jg, j_load_config(dataset="synthetic", model="LightGCN",
                                                         overrides=over), save_artifacts=False)
    finally:
        jax.config.update("jax_enable_x64", was)
    calls = []
    real_call = ttrainer.TrainScan.__call__

    def spy(self, params, seed_, epoch0, n_steps, *rest):
        calls.append((epoch0, n_steps))
        return real_call(self, params, seed_, epoch0, n_steps, *rest)

    monkeypatch.setattr(ttrainer.TrainScan, "__call__", spy)
    got = ttrainer.train_lightgcn(tg, tcfg.load_config(dataset="synthetic", model="LightGCN",
                                                       overrides=over),
                                  save_artifacts=False, device="cpu")
    assert calls == [(1, 3), (4, 1), (5, 3), (8, 1)]
    assert got.history["iters"] == want.history["iters"] == [0, 4, 8]
    table_tol, hist_tol = (1e-10, 0.0) if dtype == "float64" else (1e-5, 2e-5)
    for name in want.history:
        np.testing.assert_allclose(got.history[name], want.history[name], rtol=0,
                                   atol=hist_tol, err_msg=name)
    for g, w in zip(got.params, want.params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=table_tol)


def test_scan_chunk_flag_in_both_packages(tmp_path, monkeypatch):
    monkeypatch.setattr(j_common, "enable_compilation_cache", lambda *a, **kw: None)
    argv = ["--dataset", "synthetic", "--workdir", str(tmp_path), "--scan-chunk", "7"]
    j_cfg = j_common.config_from_args(j_common.base_parser("jax").parse_args(argv))
    t_cfg = t_common.config_from_args(t_common.base_parser("port").parse_args(argv))
    assert j_cfg.compute.scan_chunk == t_cfg.compute.scan_chunk == 7
    default = t_common.base_parser("port").parse_args(argv[:-2])
    assert default.scan_chunk is None
    assert t_common.config_from_args(default).compute.scan_chunk == 0


def test_resume_mid_interval_is_bitwise(tmp_path):
    """Evals every 4 epochs, checkpoints every 3, chunks of at most 2: the
    first run stops after epoch 7 (checkpoints at 3 and 6), the second
    resumes at epoch 7, inside the interval 5-8."""
    _, tg = _graph_pair()
    ckpt = str(tmp_path / "ckpt")
    over = {"compute.scan_chunk": 2}
    full = ttrainer.train_lightgcn(tg, _cfg(13, **over), save_artifacts=False,
                                   checkpoint_dir=str(tmp_path / "full"), checkpoint_every=3,
                                   device="cpu")
    ttrainer.train_lightgcn(tg, _cfg(8, **over), save_artifacts=False, checkpoint_dir=ckpt,
                            checkpoint_every=3, device="cpu")
    assert tckpt._epochs(ckpt) == [3, 6]
    resumed = ttrainer.train_lightgcn(tg, _cfg(13, **over), save_artifacts=False,
                                      checkpoint_dir=ckpt, checkpoint_every=3, device="cpu")
    assert resumed.history["iters"] == [8, 12]
    for name, col in full.history.items():
        assert resumed.history[name] == col[2:], name
    for g, w in zip(resumed.params, full.params):
        assert torch.equal(g, w)
    _, _, s_full = tckpt.restore_train_state(str(tmp_path / "full"), "cpu", 12)
    _, _, s_res = tckpt.restore_train_state(ckpt, "cpu", 12)
    for name in s_full:
        for m in s_full[name]:
            assert torch.equal(s_full[name][m], s_res[name][m]), (name, m)

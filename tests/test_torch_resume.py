"""Mid-train resume in the port (``train/checkpoint.py`` and the trainer's
resume branch), and a JAX training state carried across.

- A run stopped after a checkpoint and resumed equals the uninterrupted run
  bitwise on the CPU, one thread (tables and the history rows the resumed
  run computes): the dense f32 route, the dense f64 route, COO
  (``compute.dense_threshold=1.0``), and the CSR evaluation
  (``DENSIFY_BUDGET_BYTES`` shrunk, as ``tests/test_torch_large_train.py``
  shrinks it) on the bf16-dense rung and on the kernel route (its twin on
  the CPU). Each epoch draws from its own generator, so the resumed run's
  triples are the uninterrupted run's.
- Save then restore is bitwise; at most three checkpoints are kept; a
  missing directory restores None.
- The history CSV of a resumed run reads ``[0, 5, 10, 15]``
  (``tests/test_checkpoint.py:202``) and equals the uninterrupted run's but
  for the val loss of the carried rows (the val draw at epoch e is seeded
  by (seed, epochs + e), the JAX package's ``fold_in(key, epochs + e)``, so
  a shorter first run draws other val negatives).
- A JAX run checkpointed by orbax at epoch 10, converted by
  ``train_state_from_jax`` and resumed in the port to epoch 20, on the
  injected stream of ``tests/test_torch_train_run.py``, matches JAX's
  uninterrupted 20-epoch run at f64: identical history rows, tables within
  1e-10.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_train_run import _stream  # noqa: E402

from lgcnhs_tpu.config import load_config as j_load_config
from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.models.lightgcn import LightGCNParams as JParams
from lgcnhs_tpu.train import checkpoint as jckpt
from lgcnhs_tpu.train import trainer as jtrainer
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams as TParams
from lgcnhs_tpu_torch.runtime.table import read_csv
from lgcnhs_tpu_torch.train import checkpoint as tckpt
from lgcnhs_tpu_torch.train import trainer as ttrainer

U, I, D = 50, 70, 12


@pytest.fixture(autouse=True)
def one_thread():
    """Bitwise reruns need one CPU thread: past their grain size PyTorch's
    CPU kernels split sums by thread, in an order that can change between
    runs (two uninterrupted prod-preset runs at 120 x 200 differ by ~1e-7 at
    f32 with several threads, and not at all with one)."""
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


def _cfg(epochs, dtype="float32", workdir="artifacts", **over):
    return tcfg.load_config(dataset="synthetic", model="LightGCN", workdir=workdir, overrides={
        "hparams.epochs": epochs, "hparams.epoch_per_eval": 4, "hparams.batch_size": 32,
        "hparams.embedding_dim": D, "hparams.lr": 1e-2, "hparams.epoch_per_lr_decay": 3,
        "hparams.gamma": 0.9, "k": 5, "compute.dtype": dtype, **over})


ROUTES = {
    "dense-f32": ("float32", {}),
    "dense-f64": ("float64", {}),
    "coo": ("float32", {"compute.dense_threshold": 1.0}),
    "rung-csr-eval": ("bfloat16", {}),
    "kernel-twin-csr-eval": ("bfloat16", {}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_resumed_run_equals_uninterrupted_run_bitwise(tmp_path, monkeypatch, route):
    dtype, over = ROUTES[route]
    if route.endswith("csr-eval"):
        monkeypatch.setattr(ttrainer, "DENSIFY_BUDGET_BYTES", 3.0 * U * I)
        monkeypatch.setattr(ttrainer, "HOST_INCIDENCE_BUILD_BYTES", 0.0)
    if route == "kernel-twin-csr-eval":
        monkeypatch.setattr(ttrainer, "uses_kernels", lambda compute, device: compute.use_pallas)
    logged = []
    monkeypatch.setattr(ttrainer.get_logger(), "info",
                        lambda msg, *a, **kw: logged.append(msg % a if a else msg))
    _, tg = _graph_pair()
    ckpt = str(tmp_path / "ckpt")

    full = ttrainer.train_lightgcn(tg, _cfg(15, dtype, **over), save_artifacts=False,
                                   device="cpu")
    first = ttrainer.train_lightgcn(tg, _cfg(8, dtype, **over), save_artifacts=False,
                                    checkpoint_dir=ckpt, checkpoint_every=7, device="cpu")
    assert tckpt._epochs(ckpt) == [7]
    resumed = ttrainer.train_lightgcn(tg, _cfg(15, dtype, **over), save_artifacts=False,
                                      checkpoint_dir=ckpt, checkpoint_every=7, device="cpu")
    assert "resumed from checkpoint at epoch 7" in logged
    assert tckpt._epochs(ckpt) == [7, 14]
    want = {"dense-f32": "plain dense", "dense-f64": "plain dense", "coo": "COO",
            "rung-csr-eval": "bf16-dense rung", "kernel-twin-csr-eval": "dual_matmul"}[route]
    assert any(m.startswith("training LightGCN") and want in m for m in logged)
    if route.endswith("csr-eval"):
        assert any(m.startswith("evaluating LightGCN on the CSR") for m in logged)
    assert first.history["iters"] == [0, 4]
    assert resumed.history["iters"] == [8, 12]
    for name, col in full.history.items():
        assert resumed.history[name] == col[2:], name
    for g, w in zip(resumed.params, full.params):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_save_restore_round_trip_is_bitwise_and_keeps_three(tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "ckpt")
    saved = {}
    for epoch in (3, 6, 9, 12, 15):
        params = TParams(*(torch.from_numpy(rng.standard_normal(s)) for s in ((U, D), (I, D))))
        state = {n: {"exp_avg": torch.from_numpy(rng.standard_normal(t.shape)),
                     "exp_avg_sq": torch.from_numpy(rng.random(t.shape)),
                     "step": torch.tensor(float(epoch + 1))}
                 for n, t in zip(tckpt.TABLES, params)}
        tckpt.save_train_state(path, epoch, params, state)
        saved[epoch] = (params, state)
    assert sorted(os.listdir(path)) == ["12", "15", "9"]
    assert os.listdir(os.path.join(path, "15")) == [tckpt.STATE_FILE]
    for epoch in (None, 12):
        got_epoch, params, state = tckpt.restore_train_state(path, epoch=epoch)
        want_params, want_state = saved[got_epoch]
        assert got_epoch == (15 if epoch is None else 12)
        for g, w in zip(params, want_params):
            assert g.dtype == w.dtype and torch.equal(g, w)
        for n in tckpt.TABLES:
            for m in tckpt.MOMENTS:
                assert torch.equal(state[n][m], want_state[n][m]), (n, m)
    assert tckpt.restore_train_state(path, epoch=3) is None
    # a checkpoint directory without its finished file is not a checkpoint
    os.makedirs(os.path.join(path, "18"))
    assert tckpt.restore_train_state(path)[0] == 15


def test_restore_missing_returns_none(tmp_path):
    assert tckpt.restore_train_state(str(tmp_path / "nope")) is None


def test_resume_extends_the_history_csv(tmp_path):
    _, tg = _graph_pair(12)

    def cfg(epochs, workdir):
        return _cfg(epochs, workdir=str(tmp_path / workdir), **{"hparams.epoch_per_eval": 5})

    ckpt = str(tmp_path / "ckpt")
    ttrainer.train_lightgcn(tg, cfg(11, "resumed"), checkpoint_dir=ckpt, checkpoint_every=10,
                            device="cpu")
    resumed = ttrainer.train_lightgcn(tg, cfg(20, "resumed"), checkpoint_dir=ckpt,
                                      checkpoint_every=10, device="cpu")
    full = ttrainer.train_lightgcn(tg, cfg(20, "full"), device="cpu")
    name = f"LightGCN_{cfg(20, 'x').k}_val_metrics.csv"
    table = read_csv(os.path.join(cfg(20, "resumed").pictures_path, name))
    want = read_csv(os.path.join(cfg(20, "full").pictures_path, name))
    assert table["iters"] == resumed.history["iters"] == [0, 5, 10, 15]
    for col in table:
        if col != "val_loss":
            assert table[col] == want[col] == full.history[col], col
    assert table["val_loss"][3] == want["val_loss"][3]


def test_corrupt_history_csv_does_not_stop_training(tmp_path, monkeypatch):
    _, tg = _graph_pair(13)
    cfg = _cfg(6, workdir=str(tmp_path / "w"))
    ckpt = str(tmp_path / "ckpt")
    ttrainer.train_lightgcn(tg, cfg.replace(hparams=cfg.hparams.__class__(
        **{**cfg.hparams.__dict__, "epochs": 4})), checkpoint_dir=ckpt, checkpoint_every=3,
        device="cpu")
    path = os.path.join(cfg.pictures_path, f"LightGCN_{cfg.k}_val_metrics.csv")
    with open(path, "w") as f:
        f.write("iters,train_loss\n0\n")
    warned = []
    monkeypatch.setattr(ttrainer.get_logger(), "warning",
                        lambda msg, *a: warned.append(msg % a))
    result = ttrainer.train_lightgcn(tg, cfg, checkpoint_dir=ckpt, checkpoint_every=3,
                                     device="cpu")
    assert result.history["iters"] == [4]
    assert any("could not carry prior history" in m for m in warned)


def test_jax_state_resumes_in_the_port(tmp_path, monkeypatch):
    """JAX trains 11 epochs with an orbax checkpoint at 10; its state, read
    back by orbax, converted and written as a port checkpoint, resumes in
    the port to epoch 20 and meets JAX's own 20-epoch run."""
    seed, epochs, eval_every, batch = 42, 20, 3, 32
    graphs = _graph_pair(14)
    train_es = tgraph.unique_edges(graphs[1].train)
    val_es = tgraph.unique_edges(graphs[1].val)
    tab, _ = _stream(train_es, val_es, I, epochs, eval_every, batch, 12)
    val_negs = np.random.default_rng(13).integers(0, I, val_es.users.shape[0])
    rng = np.random.default_rng(15)
    ue0, ie0 = (0.1 * rng.standard_normal((n, D)) for n in (U, I))

    key = jax.random.split(jax.random.PRNGKey(seed))[0]  # train_lightgcn's base key
    train_keys = jnp.asarray(np.stack([np.asarray(jax.random.fold_in(key, e))
                                       for e in range(epochs)]))
    tab_j = jnp.asarray(tab.astype(np.int32))

    def j_sampler(k, edge_users, edge_items, pos_mask, batch_size, n_items):
        t = tab_j[jnp.argmax(jnp.all(train_keys == k[None, :], axis=1))]
        return t[0], t[1], t[2]

    def t_sampler(generator, edge_users, edge_items, pos_mask, batch_size, n_items):
        t = torch.from_numpy(tab[generator.initial_seed() & 0xFFFFFFFF].astype(np.int64))
        return t[0], t[1], t[2]

    # one fixed negative a val edge for every eval (the val draw of a run
    # depends on its epoch count; it never reaches the tables)
    monkeypatch.setattr(jtrainer, "sample_bpr_batch", j_sampler)
    monkeypatch.setattr(jtrainer, "sample_negatives_for_edges",
                        lambda k, eu, ei, *a, **kw: (eu, ei, jnp.asarray(val_negs, jnp.int32)))
    monkeypatch.setattr(jtrainer, "init_lightgcn",
                        lambda *a, **kw: JParams(jnp.asarray(ue0), jnp.asarray(ie0)))
    monkeypatch.setattr(ttrainer, "sample_bpr_batch", t_sampler)
    monkeypatch.setattr(ttrainer, "sample_negatives_for_edges",
                        lambda g, eu, ei, *a, **kw: (eu, ei, torch.from_numpy(val_negs)))
    over = {"hparams.seed": seed, "hparams.embedding_dim": D, "hparams.lr": 1e-2,
            "hparams.gamma": 0.9, "hparams.epoch_per_eval": eval_every,
            "hparams.epoch_per_lr_decay": 2, "hparams.batch_size": batch,
            "hparams.epsilon": 1e-4, "k": 5, "compute.dtype": "float64"}
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        j_cfg = j_load_config(dataset="synthetic", model="LightGCN",
                              overrides={**over, "hparams.epochs": 11})
        jtrainer.train_lightgcn(graphs[0], j_cfg, save_artifacts=False, checkpoint_dir=jdir,
                                checkpoint_every=10)
        like = JParams(jnp.asarray(ue0), jnp.asarray(ie0))
        epoch, j_params, j_opt = jckpt.restore_train_state(
            jdir, like, jtrainer.make_optimizer(j_cfg.hparams).init(like))
        j_params, j_opt = jax.tree.map(np.asarray, (j_params, j_opt))
        want = jtrainer.train_lightgcn(graphs[0], j_cfg.replace(hparams=j_cfg.hparams.__class__(
            **{**j_cfg.hparams.__dict__, "epochs": epochs})), save_artifacts=False)
    finally:
        jax.config.update("jax_enable_x64", was)
    assert epoch == 10

    params, state = tckpt.train_state_from_jax(j_params, j_opt)
    assert params.user_emb.dtype == state["user_emb"]["exp_avg"].dtype == torch.float64
    assert float(state["item_emb"]["step"]) == 11.0
    tckpt.save_train_state(tdir, epoch, params, state)
    t_cfg = tcfg.load_config(dataset="synthetic", model="LightGCN",
                             overrides={**over, "hparams.epochs": epochs})
    got = ttrainer.train_lightgcn(graphs[1], t_cfg, save_artifacts=False, checkpoint_dir=tdir,
                                  device="cpu")
    assert got.history["iters"] == [12, 15, 18]
    for name, col in want.history.items():
        assert got.history[name] == col[-3:], name
    for g, w in zip(got.params, want.params):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-10)


def test_jax_table_sharded_coo_state_loads_in_the_port(tmp_path):
    """A JAX run on a (2, 4) mesh with ``compute.coo_table_sharding`` (the
    COO route forced) checkpoints its tables and Adam moments padded to the
    model axis (52 x 12 and 72 x 12 for 50 x 70). ``train_state_from_jax``
    with the true catalog cuts the zero padding; the port then resumes the
    state on one device, on the COO route, from the epoch after it."""
    graphs = _graph_pair(17)
    over = {"hparams.embedding_dim": D, "hparams.epochs": 8, "hparams.epoch_per_eval": 4,
            "hparams.batch_size": 32, "k": 5, "compute.dense_threshold": 1.0}
    j_cfg = j_load_config(dataset="synthetic", model="LightGCN", overrides={
        **over, "hparams.epoch_per_eval": 7, "compute.mesh_shape": (2, 4),
        "compute.coo_table_sharding": True})
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jtrainer.train_lightgcn(graphs[0], j_cfg, save_artifacts=False, checkpoint_dir=jdir,
                            checkpoint_every=7)
    like = JParams(jnp.zeros((52, D)), jnp.zeros((72, D)))
    epoch, j_params, j_opt = jckpt.restore_train_state(
        jdir, like, jtrainer.make_optimizer(j_cfg.hparams).init(like))
    j_params, j_opt = jax.tree.map(np.asarray, (j_params, j_opt))
    assert epoch == 7 and j_params.user_emb.shape == (52, D)
    with pytest.raises(ValueError, match="not zero padding"):
        tckpt.train_state_from_jax(j_params, j_opt, n_users=U - 1, n_items=I)

    params, state = tckpt.train_state_from_jax(j_params, j_opt, n_users=U, n_items=I)
    adam = j_opt.inner_state[0]
    for name, n in (("user_emb", U), ("item_emb", I)):
        np.testing.assert_array_equal(getattr(params, name).numpy(),
                                      getattr(j_params, name)[:n])
        np.testing.assert_array_equal(state[name]["exp_avg"].numpy(), getattr(adam.mu, name)[:n])
        np.testing.assert_array_equal(state[name]["exp_avg_sq"].numpy(),
                                      getattr(adam.nu, name)[:n])
        assert float(state[name]["step"]) == 8.0
    tckpt.save_train_state(tdir, epoch, params, state)
    got = ttrainer.train_lightgcn(graphs[1], tcfg.load_config(
        dataset="synthetic", model="LightGCN", overrides={**over, "hparams.epochs": 13}),
        save_artifacts=False, checkpoint_dir=tdir, device="cpu")
    assert got.history["iters"] == [8, 12]
    assert all(np.isfinite(v) for col in got.history.values() for v in col)

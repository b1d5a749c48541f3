"""The training slice as a whole against the JAX package: ``train_lightgcn``
and ``cli/retrieve`` on an empty workdir (train, then serve).

torch cannot reproduce ``jax.random``, so both packages get the same
injected initial tables (``init_lightgcn[_opti]``) and the same injected
triple stream (``sample_bpr_batch``, ``sample_negatives_for_edges``), as
``tests/test_reference_differential.py`` injects them into the JAX trainer:
the JAX stubs are keyed by the ``fold_in`` key of the epoch, the port's by
its epoch generator's seed (``trainer.epoch_seed``).

Tolerances: at f64 an identical history and final tables within 1e-10;
at f32 the history within 2e-5 (f32 sums in another order can move a
5-decimal rounding by one unit) and the tables within 1e-5. The served
lists are tie-equivalent (agreement >= 0.999, every mismatched slot within
5e-4 relative under an f64 reference), the contract of the serving slice.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_checks import tie_equivalence  # noqa: E402

from lgcnhs_tpu.cli import retrieve as j_retrieve
from lgcnhs_tpu.config import load_config as j_load_config
from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.models.lightgcn import LightGCNParams as JParams
from lgcnhs_tpu.train import trainer as jtrainer
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import retrieve as t_retrieve
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams as TParams
from lgcnhs_tpu_torch.models.recommenders import checkpoint_path
from lgcnhs_tpu_torch.ops.diffusion import general_spreading_matrix, hybrid_transfer
from lgcnhs_tpu_torch.train import trainer as ttrainer


def _stream(train_es, val_es, n_items, epochs, eval_every, batch, seed):
    """Per-epoch (users, pos, neg) triples drawn from the train edges, and
    one negative per val edge for each eval epoch."""
    rng = np.random.default_rng(seed)
    E = train_es.users.shape[0]
    tab = []
    for _ in range(epochs):
        idx = rng.integers(0, E, batch)
        tab.append(np.stack([train_es.users[idx], train_es.items[idx],
                             rng.integers(0, n_items, batch)]).astype(np.int32))
    val_negs = {e: rng.integers(0, n_items, val_es.users.shape[0]).astype(np.int32)
                for e in range(0, epochs, eval_every)}
    return np.stack(tab), val_negs


def _inject(monkeypatch, seed, epochs, tab, val_negs, val_es, ue0, ie0):
    """The same tables and triple stream into both trainers."""
    key = jax.random.split(jax.random.PRNGKey(seed))[0]  # train_lightgcn's base key
    train_keys = jnp.asarray(np.stack([np.asarray(jax.random.fold_in(key, e))
                                       for e in range(epochs)]))
    val_keys = {e: np.asarray(jax.random.fold_in(key, epochs + e)) for e in val_negs}
    tab_j = jnp.asarray(tab)

    def j_sampler(k, edge_users, edge_items, pos_mask, batch_size, n_items):
        t = tab_j[jnp.argmax(jnp.all(train_keys == k[None, :], axis=1))]
        return t[0], t[1], t[2]

    def j_negs(k, edge_users, edge_items, pos_mask, n_items, n_retries=8,
               reject_user_ids=False):
        np.testing.assert_array_equal(np.asarray(edge_users), val_es.users)
        e = next(e for e, vk in val_keys.items() if np.array_equal(vk, np.asarray(k)))
        return edge_users, edge_items, jnp.asarray(val_negs[e])

    def t_epoch(generator):
        packed = generator.initial_seed()
        assert packed >> 32 == seed
        return packed & 0xFFFFFFFF

    def t_sampler(generator, edge_users, edge_items, pos_mask, batch_size, n_items):
        t = torch.from_numpy(tab[t_epoch(generator)].astype(np.int64))
        return t[0], t[1], t[2]

    def t_negs(generator, edge_users, edge_items, pos_mask, n_items, n_retries=8,
               reject_user_ids=False):
        np.testing.assert_array_equal(edge_users.numpy(), val_es.users)
        negs = val_negs[t_epoch(generator) - epochs]
        return edge_users, edge_items, torch.from_numpy(negs.astype(np.int64))

    monkeypatch.setattr(jtrainer, "sample_bpr_batch", j_sampler)
    monkeypatch.setattr(jtrainer, "sample_negatives_for_edges", j_negs)
    monkeypatch.setattr(ttrainer, "sample_bpr_batch", t_sampler)
    monkeypatch.setattr(ttrainer, "sample_negatives_for_edges", t_negs)
    for name in ("init_lightgcn", "init_lightgcn_opti"):
        monkeypatch.setattr(jtrainer, name,
                            lambda *a, **kw: JParams(jnp.asarray(ue0), jnp.asarray(ie0)))
        monkeypatch.setattr(ttrainer, name, lambda *a, **kw: TParams(
            torch.from_numpy(ue0.copy()), torch.from_numpy(ie0.copy())))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("flavor", ["LightGCN", "LightGCNOpti"])
def test_injected_training_run_matches_jax(monkeypatch, flavor, dtype):
    """9 epochs, evals at 0/3/6, four lr decays (every 2 epochs)."""
    U, I, D, seed = 50, 70, 12, 42
    epochs, eval_every, decay_every, batch, k = 9, 3, 2, 32, 5
    rng = np.random.default_rng(11)
    tu, ti = rng.integers(0, U, 500).astype(np.int32), rng.integers(0, I, 500).astype(np.int32)
    vu, vi = rng.integers(0, U, 90).astype(np.int32), rng.integers(0, I, 90).astype(np.int32)
    graphs = [mod.InteractionGraph(U, I, mod.EdgeSet(np.r_[tu, vu], np.r_[ti, vi]),
                                   mod.EdgeSet(tu, ti), mod.EdgeSet(vu, vi),
                                   mod.EdgeSet(tu[:0], ti[:0])) for mod in (jgraph, tgraph)]
    train_es, val_es = tgraph.unique_edges(graphs[1].train), tgraph.unique_edges(graphs[1].val)
    tab, val_negs = _stream(train_es, val_es, I, epochs, eval_every, batch, 12)
    np_dtype = np.float64 if dtype == "float64" else np.float32
    ue0 = (0.1 * rng.standard_normal((U, D))).astype(np_dtype)
    ie0 = (0.1 * rng.standard_normal((I, D))).astype(np_dtype)
    _inject(monkeypatch, seed, epochs, tab, val_negs, val_es, ue0, ie0)
    over = {"hparams.seed": seed, "hparams.embedding_dim": D, "hparams.lr": 1e-2,
            "hparams.gamma": 0.9, "hparams.epochs": epochs,
            "hparams.epoch_per_eval": eval_every, "hparams.epoch_per_lr_decay": decay_every,
            "hparams.batch_size": batch, "hparams.epsilon": 1e-4, "k": k,
            "compute.dtype": dtype}
    feats = ((np.ones((U, 3), np.float32), np.ones((I, 3), np.float32))
             if flavor == "LightGCNOpti" else (None, None))
    j_cfg = j_load_config(dataset="synthetic", model=flavor, overrides=over)
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        want = jtrainer.train_lightgcn(graphs[0], j_cfg, *feats, save_artifacts=False)
    finally:
        jax.config.update("jax_enable_x64", was)
    t_cfg = tcfg.load_config(dataset="synthetic", model=flavor, overrides=over)
    got = ttrainer.train_lightgcn(graphs[1], t_cfg, *feats, save_artifacts=False,
                                  device="cpu")

    assert got.history["iters"] == want.history["iters"] == [0, 3, 6]
    if dtype == "float64":
        assert got.history == want.history
        tol = 1e-10
    else:
        for name, col in want.history.items():
            np.testing.assert_allclose(got.history[name], col, rtol=0, atol=2e-5, err_msg=name)
        tol = 1e-5
    for g, w in zip(got.params, want.params):
        assert g.dtype == (torch.float64 if dtype == "float64" else torch.float32)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


SIZE = ["--dataset", "synthetic", "--env", "dev", "--users", "120", "--items", "200",
        "--interactions", "4000", "--k", "10", "--epochs", "5", "--batch-size", "64"]


@pytest.mark.parametrize("model", ["LightGCNOpti", "SpreadLightGCNOpti"])
def test_retrieve_trains_then_serves_like_jax(monkeypatch, tmp_path, model):
    """Both CLIs on an empty workdir: train LightGCNOpti with the injected
    stream, write the checkpoint, serve; tie-equivalent lists."""
    cfg = tcfg.load_config(dataset="synthetic", model=model, workdir=str(tmp_path / "t"),
                           overrides={"k": 10, "synthetic_users": 120, "synthetic_items": 200,
                                      "synthetic_interactions": 4000, "hparams.epochs": 5})
    splits, _, _ = load_dataset(cfg)
    graph = tgraph.build_graph(splits)
    train_es, val_es = tgraph.unique_edges(graph.train), tgraph.unique_edges(graph.val)
    hp = cfg.hparams
    tab, val_negs = _stream(train_es, val_es, graph.n_items, 5, hp.epoch_per_eval, 64, 3)
    rng = np.random.default_rng(4)
    ue0 = (0.1 * rng.standard_normal((graph.n_users, hp.embedding_dim))).astype(np.float32)
    ie0 = (0.1 * rng.standard_normal((graph.n_items, hp.embedding_dim))).astype(np.float32)
    _inject(monkeypatch, hp.seed, 5, tab, val_negs, val_es, ue0, ie0)

    want = j_retrieve.main(["--platform", "cpu", "--model", model,
                            "--workdir", str(tmp_path / "j"), *SIZE])
    got = t_retrieve.main(["--device", "cpu", "--model", model,
                           "--workdir", str(tmp_path / "t"), *SIZE])
    assert got.shape == np.asarray(want).shape == (graph.n_users, 10)
    trained = ttrainer.load_checkpoint(checkpoint_path(cfg))
    j_trained = jtrainer.load_checkpoint(checkpoint_path(cfg.replace(workdir=str(tmp_path / "j"))))
    for name in ("user_emb", "item_emb"):
        np.testing.assert_allclose(getattr(trained, name).numpy(),
                                   np.asarray(getattr(j_trained, name)), rtol=0, atol=1e-5,
                                   err_msg=name)
    csv_name = f"LightGCNOpti_{cfg.k}_val_metrics.csv"
    assert os.path.exists(os.path.join(cfg.pictures_path, csv_name))
    ue, ie = trained.user_emb.double().numpy(), trained.item_emb.double().numpy()
    seen = tgraph.pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
    scores = ue @ ie.T
    if model == "LightGCNOpti":
        ref = np.where(seen, -1024.0, scores)
    else:
        A = torch.from_numpy(tgraph.interaction_matrix(graph.n_users, graph.n_items, graph.train,
                                                       graph.val, dtype=np.float64))
        W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
        ref = np.where(seen, -3.0e38, scores * (A @ W).numpy())
    agreement, gap = tie_equivalence(np.asarray(want), got, ref)
    assert agreement >= 0.999 and gap <= 5e-4, (agreement, gap)

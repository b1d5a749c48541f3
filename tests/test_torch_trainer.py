"""The training slice's pieces in the port against the JAX package: BPR,
the samplers, the validation metrics, the lr schedule and Adam, the
propagation routes of ``_loss_fn``, the history CSV, and the trainer's
dispatch rules.

Tolerances: f64 comparisons within 1e-12; the metrics identical after the
history's 5-decimal rounding; the kernel route's bf16 loss within 2^-7 of
its scale (see ``test_torch_propagation.py``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lgcnhs_tpu.config import load_config as j_load_config
from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.models import lightgcn as jlgcn
from lgcnhs_tpu.ops import metrics_ops as jmet
from lgcnhs_tpu.ops.pallas import propagation as jpallas
from lgcnhs_tpu.train import trainer as jtrainer
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.models import lightgcn as tlgcn
from lgcnhs_tpu_torch.ops import metrics_ops as tmet
from lgcnhs_tpu_torch.runtime import table as ttable
from lgcnhs_tpu_torch.train import trainer as ttrainer

U, I, D = 40, 60, 8


def _x64(fn):
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        return fn()
    finally:
        jax.config.update("jax_enable_x64", was)


def _graph_pair(seed=0, n_train=400, n_val=80):
    """The same random split as a JAX and a port InteractionGraph."""
    rng = np.random.default_rng(seed)
    tu, ti = (rng.integers(0, n, n_train).astype(np.int32) for n in (U, I))
    vu, vi = (rng.integers(0, n, n_val).astype(np.int32) for n in (U, I))
    out = []
    for mod in (jgraph, tgraph):
        tr, va = mod.EdgeSet(tu, ti), mod.EdgeSet(vu, vi)
        out.append(mod.InteractionGraph(
            n_users=U, n_items=I, all=mod.EdgeSet(np.r_[tu, vu], np.r_[ti, vi]),
            train=tr, val=va, test=mod.EdgeSet(tu[:0], ti[:0])))
    return out


# -- BPR ------------------------------------------------------------------------


def test_bpr_loss_and_grads_match_jax():
    rng = np.random.default_rng(1)
    arrays = [rng.standard_normal((32, D)) for _ in range(6)]
    eps = 1e-3
    want_loss, want_grads = _x64(lambda: jax.value_and_grad(
        lambda *a: jlgcn.bpr_loss(*a, eps), argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrays)))
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    loss = tlgcn.bpr_loss(*ts, eps)
    grads = torch.autograd.grad(loss, ts)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-12)
    for g, w in zip(grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=1e-14)
    # the reference's sign flip: better ranking lowers the loss
    u = torch.ones((4, 2))
    good = tlgcn.bpr_loss(u, u * 0, u, u * 0, -u, u * 0, 0.0)
    bad = tlgcn.bpr_loss(u, u * 0, -u, u * 0, u, u * 0, 0.0)
    assert good < bad


# -- samplers ---------------------------------------------------------------------


def _positives(seed, density=0.1):
    rng = np.random.default_rng(seed)
    pos = rng.random((U, I)) < density
    pos[:, 0] = True  # every user has a positive
    users, items = np.nonzero(pos)
    return torch.from_numpy(pos), torch.from_numpy(users), torch.from_numpy(items)


def test_sample_bpr_batch_properties():
    pos, eu, ei = _positives(2)
    draw = lambda seed: tlgcn.sample_bpr_batch(  # noqa: E731
        torch.Generator().manual_seed(seed), eu, ei, pos, 4096, I)
    users, pos_items, negs = draw(5)
    assert users.shape == pos_items.shape == negs.shape == (4096,)
    assert bool(pos[users, pos_items].all())  # every (user, pos) is a train edge
    assert not bool(pos[users, negs].any())  # no negative is a positive
    assert int(negs.min()) >= 0 and int(negs.max()) < I
    assert len(set(negs.tolist())) > I // 2  # uniform over the catalog
    for a, b in zip(draw(5), (users, pos_items, negs)):
        assert torch.equal(a, b)  # one seed, one stream
    assert not torch.equal(draw(6)[0], users)


def test_sample_negatives_for_edges_properties():
    pos, eu, ei = _positives(3)
    g = torch.Generator().manual_seed(7)
    users, items, negs = tlgcn.sample_negatives_for_edges(g, eu, ei, pos, I)
    assert torch.equal(users, eu) and torch.equal(items, ei)  # every edge once, in order
    assert not bool(pos[users, negs].any())
    # reject_user_ids: no negative equals the edge's user id
    _, _, negs2 = tlgcn.sample_negatives_for_edges(
        torch.Generator().manual_seed(7), eu, ei, pos, I, reject_user_ids=True)
    assert not bool((negs2 == eu).any()) and not bool(pos[eu, negs2].any())
    # the first clean round wins: with no positives at all, round 0's draw
    first = tlgcn.sample_negatives_for_edges(
        torch.Generator().manual_seed(9), eu, ei, torch.zeros_like(pos), I)[2]
    round0 = torch.randint(0, I, (8, eu.shape[0]), generator=torch.Generator().manual_seed(9))[0]
    assert torch.equal(first, round0)


# -- metrics ----------------------------------------------------------------------


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    k = 7
    rec = np.stack([rng.permutation(I)[:k] for _ in range(U)]).astype(np.int32)
    pos = rng.random((U, I)) < 0.15
    pos[3] = False  # a user absent from the split
    counts = pos.sum(1) + rng.integers(0, 2, U)  # row counts may exceed unique pairs
    present = pos.any(1)
    inter = (rng.random((U, I)) < 0.2).astype(np.float32)
    deg = inter.sum(0).astype(np.int64)
    deg[5] = 0
    inter[:, 5] = 0
    j = [jnp.asarray(a) for a in (rec, pos, counts, present, inter, deg)]
    t = [torch.from_numpy(a) for a in (rec, pos, counts, present, inter, deg)]
    hits_t, hits_j = tmet.hit_matrix(t[0], t[1]), jmet.hit_matrix(j[0], j[1])
    np.testing.assert_array_equal(hits_t.numpy(), np.asarray(hits_j))
    pairs = [
        (tmet.precision_recall(*t[:4]), jmet.precision_recall(*j[:4])),
        (tmet.precision_recall_from_hits(hits_t, t[2], t[3]),
         jmet.precision_recall_from_hits(hits_j, j[2], j[3])),
        ((tmet.ndcg_at_k(t[0], t[1], t[3]),), (jmet.ndcg_at_k(j[0], j[1], j[3]),)),
        ((tmet.ndcg_from_hits(hits_t, t[3]),), (jmet.ndcg_from_hits(hits_j, j[3]),)),
        ((tmet.hamming_distance(t[0], I),), (jmet.hamming_distance(j[0], I),)),
        ((tmet.internal_similarity(t[0], t[4], t[5]),),
         (jmet.internal_similarity(j[0], j[4], j[5]),)),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert round(float(g), 5) == round(float(w), 5)
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5)
    np.testing.assert_allclose(tmet.similarity_matrix(t[4], t[5]).numpy(),
                               np.asarray(jmet.similarity_matrix(j[4], j[5])), rtol=1e-6)


# -- lr schedule and Adam -------------------------------------------------------------


def test_lr_schedule_matches_jax():
    t_sched = ttrainer.lr_schedule(1e-3, 0.95, 200)
    j_sched = jtrainer.lr_schedule(1e-3, 0.95, 200)
    steps = (0, 1, 200, 201, 400, 401, 1000, 9999)
    want64 = _x64(lambda: [float(j_sched(jnp.asarray(s))) for s in steps])
    for step, w64 in zip(steps, want64):
        assert t_sched(step) == pytest.approx(w64, rel=1e-13)  # JAX under x64
        assert t_sched(step) == pytest.approx(float(j_sched(step)), rel=1e-5)  # JAX's f32
    assert t_sched(200) == 1e-3 and t_sched(201) == 1e-3 * 0.95


def test_adam_trajectory_matches_optax():
    """torch Adam with the scheduled lr against the JAX trainer's optax
    optimizer on one gradient stream, at f64: 13 steps over three decays."""
    rng = np.random.default_rng(5)
    hp = tcfg.load_config(overrides={"hparams.lr": 1e-2, "hparams.gamma": 0.9,
                                     "hparams.epoch_per_lr_decay": 4}).hparams
    w0 = rng.standard_normal((5, 3))
    grads = [rng.standard_normal((5, 3)) for _ in range(13)]

    def run_optax():
        opt = jtrainer.make_optimizer(hp)
        w = jnp.asarray(w0)
        state = opt.init(w)
        for g in grads:
            upd, state = opt.update(jnp.asarray(g), state, w)
            w = optax.apply_updates(w, upd)
        return np.asarray(w)

    want = _x64(run_optax)
    params = tlgcn.LightGCNParams(torch.tensor(w0, requires_grad=True),
                                  torch.zeros((1, 3), dtype=torch.float64, requires_grad=True))
    opt = ttrainer.make_optimizer(hp, params)
    sched = ttrainer.lr_schedule(hp.lr, hp.gamma, hp.epoch_per_lr_decay)
    for e, g in enumerate(grads):
        params.user_emb.grad = torch.from_numpy(g)
        params.item_emb.grad = torch.zeros((1, 3), dtype=torch.float64)
        for group in opt.param_groups:
            group["lr"] = sched(e)
        opt.step()
    np.testing.assert_allclose(params.user_emb.detach().numpy(), want, rtol=0, atol=1e-12)


# -- _loss_fn routes -------------------------------------------------------------------


@pytest.fixture(scope="module")
def loss_problem():
    jg, tg = _graph_pair(6)
    rng = np.random.default_rng(6)
    ue = (0.1 * rng.standard_normal((U, D))).astype(np.float32)
    ie = (0.1 * rng.standard_normal((I, D))).astype(np.float32)
    users = rng.integers(0, U, 64)
    pos, neg = rng.integers(0, I, 64), rng.integers(0, I, 64)
    return jg, tg, ue, ie, users, pos, neg


def _t_loss_and_grads(tg_R, ue, ie, users, pos, neg, **kw):
    params = tlgcn.LightGCNParams(torch.tensor(ue, requires_grad=True),
                                  torch.tensor(ie, requires_grad=True))
    loss = ttrainer._loss_fn(params, tg_R, torch.from_numpy(users), torch.from_numpy(pos),
                             torch.from_numpy(neg), 1e-4, 3, **kw)
    return [loss.detach().numpy(), *(g.numpy() for g in torch.autograd.grad(loss, params))]


def _close(got, want, rel):
    for g, w in zip(got, want):
        w = np.asarray(w, np.float64)
        np.testing.assert_allclose(np.asarray(g, np.float64), w, rtol=0,
                                   atol=rel * max(np.abs(w).max(), 1e-30))


def test_loss_kernel_route_through_the_twin_matches_pallas(loss_problem):
    """_loss_fn's binary kernel route (the twin on the CPU) against JAX's
    Pallas binary propagation (interpret mode) + bpr_loss."""
    jg, tg, ue, ie, users, pos, neg = loss_problem
    R8, du, di = tgraph.binary_incidence_factors(U, I, tg.train)
    factors = tuple(torch.from_numpy(a) for a in (R8, du, di))

    def j_loss(u0, i0):
        uf, itf = jpallas.lightgcn_propagate_pallas_binary(
            u0, i0, jnp.asarray(R8), jnp.asarray(du), jnp.asarray(di), 3, True, True)
        return jlgcn.bpr_loss(uf[users], u0[users], itf[pos], i0[pos], itf[neg], i0[neg], 1e-4)

    loss, grads = jax.value_and_grad(j_loss, argnums=(0, 1))(jnp.asarray(ue), jnp.asarray(ie))
    got = _t_loss_and_grads(factors, ue, ie, users, pos, neg, bf16_matmul=True, use_kernel=True)
    _close(got, [loss, *grads], 2.0 ** -7)
    # without use_kernel the factored triple takes the dense fallback
    plain = _t_loss_and_grads(factors, ue, ie, users, pos, neg)
    dense = _t_loss_and_grads(torch.from_numpy(tgraph.normalized_bipartite(U, I, tg.train)),
                              ue, ie, users, pos, neg)
    _close(plain, dense, 1e-6)


def test_loss_plain_route_matches_jax_f64(loss_problem):
    jg, tg, ue, ie, users, pos, neg = loss_problem
    R = tgraph.normalized_bipartite(U, I, tg.train, dtype=np.float64)
    ue64, ie64 = ue.astype(np.float64), ie.astype(np.float64)

    def run():
        return jax.value_and_grad(
            lambda p: jtrainer._loss_fn(p, jnp.asarray(R), jnp.asarray(users), jnp.asarray(pos),
                                        jnp.asarray(neg), 1e-4, 3))(
            jlgcn.LightGCNParams(jnp.asarray(ue64), jnp.asarray(ie64)))

    loss, grads = _x64(run)
    got = _t_loss_and_grads(torch.from_numpy(R), ue64, ie64, users, pos, neg)
    np.testing.assert_allclose(got[0], float(loss), rtol=1e-12)
    for g, w in zip(got[1:], grads):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12, atol=1e-15)


# -- history CSV -------------------------------------------------------------------------


def test_history_csv_is_byte_identical_to_pandas(tmp_path):
    history = {name: [] for name in ttrainer.HISTORY_COLUMNS}
    rows = [(0, -0.84088, 3.1, 0.0132, 1e-05, 0.0, 0.01396, 1.0, 0.10437),
            (200, -12.47871, -15.32947, 0.02123, 0.76049, 0.04131, 123456.5, 0.26502, 2e-07),
            (400, -0.1, float("nan"), 0.5, 0.25, 0.33333, 0.00001, 0.9999, 0.0)]
    for row in rows:
        for name, v in zip(ttrainer.HISTORY_COLUMNS, row):
            history[name].append(v)
    cfg_j = j_load_config(dataset="synthetic", workdir=str(tmp_path / "j"))
    cfg_t = tcfg.load_config(dataset="synthetic", workdir=str(tmp_path / "t"))
    for cfg in (cfg_j, cfg_t):
        cfg.ensure_dirs()
    jtrainer._save_history(cfg_j, "LightGCN", history)
    ttrainer._save_history(cfg_t, "LightGCN", history)
    name = f"LightGCN_{cfg_t.k}_val_metrics.csv"
    with open(os.path.join(cfg_j.pictures_path, name), "rb") as f:
        want = f.read()
    with open(os.path.join(cfg_t.pictures_path, name), "rb") as f:
        got = f.read()
    assert got == want
    empty = {name: [] for name in ttrainer.HISTORY_COLUMNS}
    assert ttable.to_csv(empty) == ",".join(ttrainer.HISTORY_COLUMNS) + "\n"


# -- dispatch rules ------------------------------------------------------------------------


def test_choose_propagation_matches_jax():
    for dtype in ("float32", "bfloat16"):
        compute = tcfg.load_config(overrides={"compute.dtype": dtype}).compute
        j_compute = j_load_config(overrides={"compute.dtype": dtype}).compute
        for shape in ((6040, 3706, 545_390), (50_000, 30_000, 2_000_000),
                      (30_000, 40_000, 2_000_000), (100, 100, 5)):
            assert ttrainer.choose_propagation(*shape, compute) == \
                jtrainer.choose_propagation(*shape, j_compute)


def test_unported_branches_raise_with_roadmap_pointers():
    """A mesh of two ranks with no process group running: the ranks come
    from the launcher, and the message names it."""
    _, tg = _graph_pair(7)
    base = tcfg.load_config(dataset="synthetic", overrides={"hparams.epochs": 1})
    cfg = base.replace(compute=base.compute.__class__(mesh_shape=(2, 1)))
    with pytest.raises(ValueError, match="no process group is running.*torchrun"):
        ttrainer.train_lightgcn(tg, cfg, save_artifacts=False, device="cpu")


def _on_world_one_mesh(tmp_path, fn):
    """fn(mesh) on a (1, 1) mesh of a world-1 gloo group (file store)."""
    import torch.distributed as dist

    from lgcnhs_tpu_torch.runtime.mesh import make_mesh

    tmp_path.mkdir(parents=True, exist_ok=True)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", world_size=1,
                            rank=0)
    try:
        return fn(make_mesh((1, 1)))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("what", ["coo", "coo_table_sharding"])
def test_mesh_coo_routes_train_on_a_world_one_mesh(tmp_path, what):
    """The trainer's mesh function on a world-1 gloo mesh trains a graph
    that takes the COO propagation (``dense_threshold=1.0``), with the
    tables replicated or row-sharded (``coo_table_sharding``), as the
    single-device COO route does: the same triples, sums in another order
    (histories within 2e-5, tables within 1e-5)."""
    _, tg = _graph_pair(7)
    over = {"hparams.epochs": 6, "hparams.epoch_per_eval": 3, "hparams.batch_size": 64,
            "hparams.embedding_dim": D, "k": 5, "compute.dense_threshold": 1.0}
    cfg = tcfg.load_config(dataset="synthetic", overrides={
        **over, "compute.coo_table_sharding": what == "coo_table_sharding"})
    want = ttrainer.train_lightgcn(tg, tcfg.load_config(dataset="synthetic", overrides=over),
                                   save_artifacts=False, device="cpu")
    got = _on_world_one_mesh(tmp_path, lambda mesh: ttrainer.train_lightgcn_on_mesh(
        tg, cfg, mesh, save_artifacts=False))
    assert got.history["iters"] == want.history["iters"] == [0, 3]
    for col, series in want.history.items():
        np.testing.assert_allclose(got.history[col], series, rtol=0, atol=2e-5, err_msg=col)
    for g, w in zip(got.params, want.params):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_coo_table_sharding_on_a_dense_graph_is_logged_and_trains(tmp_path, monkeypatch):
    """``coo_table_sharding`` on a graph that takes the dense route: logged,
    and the dense mesh plan trains as without it (JAX warns and carries on,
    ``lgcnhs_tpu/train/trainer.py:452-456``)."""
    _, tg = _graph_pair(7)
    over = {"hparams.epochs": 4, "hparams.epoch_per_eval": 2, "hparams.batch_size": 64,
            "hparams.embedding_dim": D, "k": 5}
    warned = []
    monkeypatch.setattr(ttrainer.get_logger(), "warning",
                        lambda msg, *a: warned.append(msg % a))
    runs = [_on_world_one_mesh(tmp_path / str(flag), lambda mesh: ttrainer.train_lightgcn_on_mesh(
        tg, tcfg.load_config(dataset="synthetic", overrides={
            **over, "compute.coo_table_sharding": flag}), mesh, save_artifacts=False))
        for flag in (True, False)]
    assert any("coo_table_sharding requested but the graph takes the dense path" in m
               for m in warned)
    assert runs[0].history == runs[1].history
    for a, b in zip(runs[0].params, runs[1].params):
        assert torch.equal(a, b)


def test_auto_mesh_on_one_rank_keeps_the_bf16_dense_route(monkeypatch):
    """``--mesh auto`` with one rank resolves to no mesh, so the trainer
    prices the bf16 incidence at 2 bytes an entry, as JAX's trainer does
    (``single_chip=mesh is None``): a bf16 graph between the bf16 and the f32
    budgets (the 2-4 GB band, the budget shrunk to this graph) trains on
    JAX's one-device route, dense, where the ``(1, 1)`` proxy says COO."""
    _, tg = _graph_pair(7)
    E = tg.train.n_edges
    budget = 3.0 * U * I  # 2 bytes an entry fit it, 4 do not
    monkeypatch.setattr(ttrainer, "DENSIFY_BUDGET_BYTES", budget)
    monkeypatch.setattr(jtrainer, "DENSIFY_BUDGET_BYTES", budget)
    base = tcfg.load_config(dataset="synthetic", overrides={"hparams.epochs": 1})
    cfg = base.replace(compute=base.compute.__class__(dtype="bfloat16", mesh_shape=(0, 0)))
    j_base = j_load_config(dataset="synthetic")
    j_compute = j_base.compute.__class__(dtype="bfloat16", mesh_shape=(0, 0))
    want = jtrainer.choose_propagation(U, I, E, j_compute, single_chip=True)
    assert want == "dense" != ttrainer.choose_propagation(U, I, E, cfg.compute)
    routes = []
    choose = ttrainer.choose_propagation

    def spy(*args, **kwargs):
        routes.append(choose(*args, **kwargs))
        return routes[-1]

    monkeypatch.setattr(ttrainer, "choose_propagation", spy)
    ttrainer.train_lightgcn(tg, cfg, save_artifacts=False, device="cpu")
    assert routes == [want]


def test_training_defaults_to_the_card(monkeypatch):
    """Without ``device`` the trainer asks for CUDA and raises without it;
    it never trains on the CPU unasked."""
    _, tg = _graph_pair(9)
    cfg = tcfg.load_config(dataset="synthetic", overrides={"hparams.epochs": 1})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrainer.train_lightgcn(tg, cfg, save_artifacts=False)


def test_training_reduces_loss_on_the_cpu():
    _, tg = _graph_pair(8, n_train=600)
    for dtype in ("float32", "bfloat16"):  # the prod preset's plain bf16 route
        cfg = tcfg.load_config(dataset="synthetic", overrides={
            "hparams.epochs": 60, "hparams.epoch_per_eval": 20, "hparams.batch_size": 128,
            "hparams.embedding_dim": D, "compute.dtype": dtype, "k": 5})
        result = ttrainer.train_lightgcn(tg, cfg, save_artifacts=False, device="cpu")
        losses = result.history["train_loss"]
        assert result.history["iters"] == [0, 20, 40]
        assert all(np.isfinite(v) for col in result.history.values() for v in col)
        assert losses[-1] < losses[0]
        assert result.params.user_emb.dtype == torch.float32
        assert not result.params.user_emb.requires_grad
        again = ttrainer.train_lightgcn(tg, cfg, save_artifacts=False, device="cpu")
        assert again.history == result.history  # seeded: one run, one result

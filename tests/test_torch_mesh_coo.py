"""The mesh's large-graph half of ``lgcnhs_tpu_torch`` on CPU ranks: the
sorted-segment COO layout, the edge-sharded COO steps (bucketed and
segment layouts), the table-sharded steps, the user-sharded CSR top-k and
the mesh trainer on the COO route, against ``lgcnhs_tpu``.

Ranks are processes of ``tests/torch_mesh_worker.py`` (suite "coo") on
gloo, one spawn per mesh shape, every case in it; the JAX side runs in the
test process on its virtual CPU devices, on a JAX mesh of the same shape.
The toy graph is 45 users x 130 items, which divides neither model axis
(the padded catalog is exercised).

- ``build_edge_ordering`` identical to JAX's; ``lightgcn_propagate_coo_sorted``
  and its gradient within 1e-12 of JAX's at x64.
- ``shard_coo_edges``: each rank's six arrays equal to its slice of JAX's
  per-shard-sorted arrays.
- One ``make_sharded_coo_train_step`` step of each layout, on the same
  initial tables and injected triples (torch cannot draw ``jax.random``'s
  stream), against JAX's step: loss and tables within 1e-6
  (``tests/test_sharding.py:365-373``'s bar, the JAX mesh against one
  device).
- The table-sharded step against the replicated one (loss and tables
  within 1e-6; each rank holds U_pad/M and I_pad/M rows of the tables and
  of both Adam moments; padded rows zero); its scan equals its step loop.
- ``distributed_csr_masked_topk`` ids identical to JAX's at U=53
  (``tests/test_sharding.py:426-444``), and at U=5, where a rank's block
  is empty on 4 ranks.
- ``train_lightgcn`` with a mesh and ``dense_threshold=1.0``, replicated and
  table-sharded, against the port's single-device COO run: histories within
  2e-5, tables within 1e-5 (``tests/test_sharding.py:378-420``), with the
  single-device COO factories poisoned; every rank returns the same
  tables. Resume (8 epochs with a checkpoint at 7, then to 14) against 14
  in one go within rtol 2e-4, atol 1e-5 (``tests/test_checkpoint.py:91-160``).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lgcnhs_tpu.config import load_config as j_load_config
from lgcnhs_tpu.data.graph import EdgeSet as JEdgeSet
from lgcnhs_tpu.models.lightgcn import init_lightgcn as j_init_lightgcn
from lgcnhs_tpu.ops import propagation as jprop
from lgcnhs_tpu.ops import scalable as jscalable
from lgcnhs_tpu.parallel import sharding as jsharding
from lgcnhs_tpu.runtime.mesh import make_mesh as j_make_mesh
from lgcnhs_tpu.train.trainer import make_optimizer as j_make_optimizer
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.data.graph import build_graph
from lgcnhs_tpu_torch.ops import propagation as tprop
from lgcnhs_tpu_torch.train import trainer as ttrainer
from torch_port_checks import MeshRun

U, I, D = 45, 130, 8
N_USERS, N_ITEMS, N_INTER = 40, 131, 1200  # the trainer cases' synthetic catalog
SHAPES = [(1, 2), (2, 2), (1, 4)]
PLANS = ["replicated", "table_sharded"]
K53 = 6


def _shape_id(s):
    return f"{s[0]}x{s[1]}"


def _toy():
    rng = np.random.default_rng(23)
    pairs = np.unique(np.stack([rng.integers(0, U, 700), rng.integers(0, I, 700)]), axis=1)
    eu, ei = pairs.astype(np.int32)
    perm = rng.permutation(eu.shape[0])  # edges in no sorted order
    return eu[perm], ei[perm]


def _csr53():
    """``tests/test_sharding.py:426-444``'s problem: 53 users (no mesh
    divides them), 700 random edges, 6 picks."""
    rng = np.random.default_rng(71)
    eu = rng.integers(0, 53, 700).astype(np.int32)
    ei = rng.integers(0, I, 700).astype(np.int32)
    rowptr, cols = jscalable.user_csr(53, JEdgeSet(eu, ei))
    ue = rng.standard_normal((53, D)).astype(np.float32)
    ie = rng.standard_normal((I, D)).astype(np.float32)
    return rowptr, cols, ue, ie


@contextlib.contextmanager
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _hp():
    cfg = j_load_config(env="dev", dataset="synthetic", model="LightGCN",
                        overrides={"hparams.batch_size": 64, "hparams.embedding_dim": D})
    return cfg.hparams


def _jparams(ue0, ie0):
    from lgcnhs_tpu.models.lightgcn import LightGCNParams

    return LightGCNParams(jnp.asarray(ue0), jnp.asarray(ie0))


def _jax_side(shape, eu, ei, norm, ue0, ie0, triples):
    """JAX on a mesh of ``shape``: the per-shard-sorted edges and one step
    of each layout on the injected triples."""
    mesh = j_make_mesh(shape)
    plan = jsharding.make_plan(mesh)
    hp = _hp()
    optimizer = j_make_optimizer(hp)
    rowptr, cols = (jnp.asarray(a) for a in jscalable.user_csr(U, JEdgeSet(eu, ei)))
    se = {"bucketed": jsharding.shard_bucketed_incidence(plan, eu, ei, norm, U, I),
          "segment": jsharding.shard_coo_edges(plan, eu, ei, jnp.asarray(norm))}
    out = {"order": [np.asarray(a) for a in se["segment"]]}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jscalable, "sample_bpr_batch_csr",
                   lambda *a, **kw: tuple(jnp.asarray(t) for t in triples))
        for layout in ("bucketed", "segment"):
            params = jax.device_put(_jparams(ue0, ie0), plan.replicated)
            step = jsharding.make_sharded_coo_train_step(plan, optimizer, hp, U, I,
                                                         layout=layout)
            p, _, loss = step(params, optimizer.init(params), jax.random.PRNGKey(9),
                              jnp.asarray(eu), jnp.asarray(ei), rowptr, cols, se[layout])
            out[layout] = (float(loss), np.asarray(p.user_emb), np.asarray(p.item_emb))
    return out


def _tcfg(**over):
    base = {"synthetic_users": N_USERS, "synthetic_items": N_ITEMS,
            "synthetic_interactions": N_INTER, "hparams.epochs": 6, "hparams.epoch_per_eval": 3,
            "hparams.batch_size": 64, "k": 7, "compute.dense_threshold": 1.0}
    return tcfg.load_config(dataset="synthetic", model="LightGCN", overrides={**base, **over})


@pytest.fixture(scope="module")
def toy():
    eu, ei = _toy()
    norm = np.array(jprop.edge_gcn_norm(jnp.asarray(eu), jnp.asarray(ei), U, I))
    ue0, ie0 = (np.array(t) for t in j_init_lightgcn(jax.random.PRNGKey(0), U, I, D))
    rng = np.random.default_rng(5)
    pick = rng.integers(0, eu.shape[0], 64)
    triples = (eu[pick], ei[pick], rng.integers(0, I, 64).astype(np.int32))
    return eu, ei, norm, ue0, ie0, triples


@pytest.fixture(scope="module")
def runs(tmp_path_factory, toy):
    """({shape: (every rank's outputs, the JAX side)}, the port's
    single-device COO run, the JAX CSR top-k ids): the mesh runs start
    first, the JAX side and the single-device run go while they run."""
    eu, ei, norm, ue0, ie0, triples = toy
    rowptr53, cols53, ue53, ie53 = _csr53()
    root = tmp_path_factory.mktemp("mesh_coo")
    started = {}
    for shape in SHAPES:
        tmp = root / _shape_id(shape)
        started[shape] = MeshRun("coo", shape, {
            "U": U, "I": I, "D": D, "eu": eu, "ei": ei, "norm": norm, "ue0": ue0, "ie0": ie0,
            "t_users": triples[0], "t_pos": triples[1], "t_neg": triples[2], "ue53": ue53,
            "ie53": ie53, "rowptr53": rowptr53, "cols53": cols53, "k53": K53,
            "users": N_USERS, "items": N_ITEMS, "interactions": N_INTER, "tmp": str(tmp)}, tmp)
    jax_sides = {shape: _jax_side(shape, eu, ei, norm, ue0, ie0, triples) for shape in SHAPES}
    csr53 = np.asarray(jsharding.distributed_csr_masked_topk(
        j_make_mesh((2, 4)), ue53, ie53, rowptr53, cols53, K53))
    csr5 = np.asarray(jsharding.distributed_csr_masked_topk(
        j_make_mesh((2, 4)), ue53[:5], ie53, rowptr53[:6], cols53[:rowptr53[5]], K53))
    graph = build_graph(load_dataset(_tcfg(), "cpu")[0])
    with _one_thread():
        single = ttrainer.train_lightgcn(graph, _tcfg(), save_artifacts=False, device="cpu")
    outs = {shape: run.results() for shape, run in started.items()}
    return {shape: (outs[shape], jax_sides[shape]) for shape in SHAPES}, single, (csr53, csr5)


@contextlib.contextmanager
def _one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(was)


# -- the sorted-segment layout, one device ---------------------------------------------


def test_build_edge_ordering_matches_jax(toy):
    eu, ei, norm = toy[:3]
    want = jprop.build_edge_ordering(jnp.asarray(eu), jnp.asarray(ei), jnp.asarray(norm))
    got = tprop.build_edge_ordering(torch.from_numpy(eu.astype(np.int64)),
                                    torch.from_numpy(ei.astype(np.int64)),
                                    torch.from_numpy(norm))
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_propagate_coo_sorted_and_gradient_match_jax_x64(toy):
    eu, ei = toy[:2]
    rng = np.random.default_rng(8)
    ue, ie = rng.standard_normal((U, D)), rng.standard_normal((I, D))
    cu, ci = rng.standard_normal((U, D)), rng.standard_normal((I, D))
    norm = rng.uniform(0.1, 1.0, eu.shape[0])  # f64 weights, the same on both sides
    with x64():
        order = jprop.build_edge_ordering(jnp.asarray(eu), jnp.asarray(ei), jnp.asarray(norm))

        def j_obj(a, b):
            fu, fi = jprop.lightgcn_propagate_coo_sorted(a, b, order, U, I, 3)
            return jnp.sum(fu * cu) + jnp.sum(fi * ci), (fu, fi)

        (_, want), want_g = jax.value_and_grad(j_obj, argnums=(0, 1), has_aux=True)(
            jnp.asarray(ue), jnp.asarray(ie))
        want, want_g = [np.asarray(w) for w in want], [np.asarray(w) for w in want_g]
    t_order = tprop.build_edge_ordering(torch.from_numpy(eu.astype(np.int64)),
                                        torch.from_numpy(ei.astype(np.int64)),
                                        torch.from_numpy(norm))
    t_ue = torch.from_numpy(ue).requires_grad_(True)
    t_ie = torch.from_numpy(ie).requires_grad_(True)
    got = tprop.lightgcn_propagate_coo_sorted(t_ue, t_ie, t_order, U, I, 3)
    (torch.sum(got[0] * torch.from_numpy(cu))
     + torch.sum(got[1] * torch.from_numpy(ci))).backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=0, atol=1e-12)
    for g, w in zip((t_ue.grad, t_ie.grad), want_g):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12)


# -- the mesh ------------------------------------------------------------------------------


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_shard_coo_edges_matches_jax_slices(runs, shape):
    outs, jax_side = runs[0][shape]
    n_dev = shape[0] * shape[1]
    fields = tprop.EdgeOrdering._fields
    for rank, out in enumerate(outs):
        for name, whole in zip(fields, jax_side["order"]):
            block = whole.shape[0] // n_dev
            np.testing.assert_array_equal(out[f"order.{name}"],
                                          whole[rank * block:(rank + 1) * block],
                                          err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("layout", ["bucketed", "segment"])
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_sharded_coo_step_matches_jax(runs, shape, layout):
    outs, jax_side = runs[0][shape]
    loss, want_u, want_i = jax_side[layout]
    for out in outs:
        assert float(out[f"step.{layout}.loss"]) == pytest.approx(loss, abs=1e-6)
        np.testing.assert_allclose(out[f"step.{layout}.user_emb"], want_u, rtol=0, atol=1e-6)
        np.testing.assert_allclose(out[f"step.{layout}.item_emb"], want_i, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_table_sharded_step_matches_replicated_and_shards_memory(runs, shape):
    """Each rank holds U_pad/M and I_pad/M rows of the tables and of both
    Adam moments; joined over the model axis (the ranks of one data row, in
    order) they are the replicated step's tables, with zero padded rows."""
    outs = runs[0][shape][0]
    n_data, n_model = shape
    U_pad, I_pad = (-(-n // n_model) * n_model for n in (U, I))
    rep = outs[0]
    for out in outs:
        assert float(out["ts.loss"]) == pytest.approx(float(rep["step.bucketed.loss"]), abs=1e-6)
        for name, n_pad in (("user_emb", U_pad), ("item_emb", I_pad)):
            for key in (f"ts.{name}", f"ts.{name}.exp_avg", f"ts.{name}.exp_avg_sq"):
                assert out[key].shape == (n_pad // n_model, D), key
    for d in range(n_data):
        row = outs[d * n_model:(d + 1) * n_model]
        for name, n in (("user_emb", U), ("item_emb", I)):
            joined = np.concatenate([out[f"ts.{name}"] for out in row])
            np.testing.assert_allclose(joined[:n], rep[f"step.bucketed.{name}"], rtol=0,
                                       atol=1e-6, err_msg=name)
            assert not joined[n:].any()
            for m in ("exp_avg", "exp_avg_sq"):
                assert not np.concatenate([out[f"ts.{name}.{m}"] for out in row])[n:].any()


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_table_sharded_scan_matches_step_sequence(runs, shape):
    for out in runs[0][shape][0]:
        assert float(out["ts_scan.loss"]) == float(out["ts_step.loss"])
        for name in ("user_emb", "item_emb"):
            np.testing.assert_array_equal(out[f"ts_scan.{name}"], out[f"ts_step.{name}"])


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_distributed_csr_masked_topk_matches_jax(runs, shape):
    want = runs[2][0]
    for out in runs[0][shape][0]:
        assert out["csr53"].dtype == np.int32
        np.testing.assert_array_equal(out["csr53"], want)


@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_distributed_csr_masked_topk_with_an_empty_rank_block(runs, shape):
    """5 users over 4 ranks: blocks of 2, the last rank's empty (it ranks
    nothing and gives only padding to the gather)."""
    want = runs[2][1]
    for out in runs[0][shape][0]:
        np.testing.assert_array_equal(out["csr5"], want)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_trainer_composes_mesh_with_coo(runs, shape, plan):
    """The mesh trainer on the COO route (the single-device COO factories
    poisoned in the ranks) against the port's single-device COO run."""
    outs = runs[0][shape][0]
    base = runs[1]
    first = outs[0]
    for name in ("user_emb", "item_emb"):
        got = first[f"train.{plan}.{name}"]
        want = getattr(base.params, name).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
        for out in outs[1:]:
            np.testing.assert_array_equal(out[f"train.{plan}.{name}"], got)
    assert list(first[f"train.{plan}.history.iters"]) == [0, 3]
    for col, series in base.history.items():
        np.testing.assert_allclose(first[f"train.{plan}.history.{col}"],
                                   np.asarray(series, np.float64), rtol=0, atol=2e-5,
                                   err_msg=col)


@pytest.mark.parametrize("plan", PLANS)
@pytest.mark.parametrize("shape", SHAPES, ids=_shape_id)
def test_resume_mesh_coo(runs, shape, plan):
    """8 epochs with a checkpoint at 7, resumed to 14 (the padded tables and
    moments saved whole, each rank's rows cut again), against 14 epochs in
    one go."""
    for out in runs[0][shape][0]:
        for name in ("user_emb", "item_emb"):
            np.testing.assert_allclose(out[f"resume.{plan}.resumed.{name}"],
                                       out[f"resume.{plan}.full.{name}"], rtol=2e-4, atol=1e-5,
                                       err_msg=name)

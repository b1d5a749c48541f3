"""The mesh and sharded training of ``lgcnhs_tpu_torch`` on CPU ranks.

Ranks are processes of ``tests/torch_mesh_worker.py`` on gloo, joined
through a file store under the test's temporary directory (one spawn per
mesh shape, module-scoped, running every case). The catalog is
``tests/test_mesh_flagship.py``'s: 40 users x 131 items, which divides
neither model axis, so the padding is exercised.

- ``mesh_from_config`` as ``tests/test_mesh_flagship.py:57-63`` holds
  JAX's: (1, 1) is no mesh, (0, 0) puts every rank on the model axis, a
  shape is taken as it is (and, here, must match the world size; without a
  process group a multi-rank shape names torchrun).
- Each rank holds only its block: (U_pad, I_pad / M) of the incidence and
  the positives, (U_pad / M, D) and (I_pad / M, D) of the tables, each a
  tensor of its own (no view into the global array).
- The mesh trainer against the single-device trainer of the port, same
  seed and config, at (1, 2), (2, 2) and (1, 4): histories within 2e-5
  absolute and tables within 1e-5 at f32 (``tests/test_mesh_flagship.py:
  66-92``'s bars; the partial sums meet in another order), tables within
  1e-10 under float64; LightGCNOpti with features, the bf16 preset, the
  factored int8 route (the ``dual_matmul`` twin) and a resume from a mesh
  checkpoint (equal to the uninterrupted mesh run) likewise. Every rank
  returns the same whole tables.
"""
import contextlib
import os
import tempfile

import numpy as np
import pytest
import torch

from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.data.graph import build_graph
from lgcnhs_tpu_torch.runtime import mesh as rmesh
from lgcnhs_tpu_torch.train import trainer as ttrainer
from torch_port_checks import MeshRun

N_USERS, N_ITEMS, N_INTER = 40, 131, 1200
SHAPES = [(1, 2), (2, 2), (1, 4)]
CASES = ["f32", "f64", "opti", "bf16", "kernel", "resume"]
D = 64  # the dev preset's embedding width
# The bf16 preset rounds each layer's operands to bf16: with the partial
# sums met in another order, an operand can round one bf16 step apart (2^-8
# relative), which can flip a small gradient's sign, and Adam then moves
# that element up to ~lr a step the other way: 2 lr a step apart at most,
# 1.2e-2 over 6 steps at lr 1e-3. Measured: up to 1.9e-3, in 2 of 8384
# item entries (the f32 and f64 runs of the same code hold 1e-5 and 1e-10).
BF16_TABLE_TOL = 2 * 1e-3 * 6


def _cfg(case, mesh_shape=(1, 1), **extra):
    over = {"synthetic_users": N_USERS, "synthetic_items": N_ITEMS,
            "synthetic_interactions": N_INTER, "hparams.epochs": 6,
            "hparams.epoch_per_eval": 3, "hparams.batch_size": 64, "k": 7,
            "compute.mesh_shape": mesh_shape,
            "compute.dtype": {"f64": "float64", "bf16": "bfloat16",
                              "kernel": "bfloat16"}.get(case, "float32")}
    over.update(extra)
    return tcfg.load_config(dataset="synthetic", model="LightGCN", overrides=over)


def _single_device(graph, uf, itf):
    """The port's single-device training of every case."""
    refs = {}
    for case in CASES:
        feats = (uf, itf) if case == "opti" else (None, None)
        with pytest.MonkeyPatch.context() as mp:
            if case == "kernel":
                mp.setattr(ttrainer, "uses_kernels", lambda compute, device: True)
            refs[case] = ttrainer.train_lightgcn(graph, _cfg(case), *feats,
                                                 save_artifacts=False, device="cpu")
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh shape: every rank's outputs}, the single-device references, the
    graph: the three mesh runs start first and the references are trained
    while they run."""
    root = tmp_path_factory.mktemp("mesh_train")
    started = {}
    for shape in SHAPES:
        tmp = root / f"{shape[0]}x{shape[1]}"
        inputs = {"users": N_USERS, "items": N_ITEMS, "interactions": N_INTER,
                  "cases": np.asarray(CASES), "tmp": str(tmp)}
        started[shape] = MeshRun("train", shape, inputs, tmp)
    splits, uf, itf = load_dataset(_cfg("f32"), "cpu")
    graph = build_graph(splits)
    refs = _single_device(graph, uf, itf)
    return {shape: run.results() for shape, run in started.items()}, refs, graph


def test_mesh_from_config_without_a_process_group():
    assert rmesh.mesh_from_config(_cfg("f32").compute) is None
    assert rmesh.mesh_from_config(_cfg("f32", (0, 0)).compute) is None  # "auto" on one rank
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 8"):
        rmesh.mesh_from_config(_cfg("f32", (2, 4)).compute)
    assert rmesh.world_size() == 1 and rmesh.is_writer()


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_from_config_on_the_ranks(runs, shape):
    world = shape[0] * shape[1]
    for out in runs[0][shape]:
        assert bool(out["none_11"])
        assert tuple(out["auto_shape"]) == (1, world)  # every rank on the model axis
        assert str(out["mismatch_msg"]) == \
            f"mesh ({world}, 2) needs {2 * world} ranks, the process group has {world}"


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_holds_only_its_block(runs, shape):
    n_model = shape[1]
    U_pad = -(-N_USERS // n_model) * n_model
    I_pad = -(-N_ITEMS // n_model) * n_model
    want = {"R": (U_pad, I_pad // n_model), "pos": (U_pad, I_pad // n_model),
            "user_emb": (U_pad // n_model, 8), "item_emb": (I_pad // n_model, 8)}
    for out in runs[0][shape]:
        for name, block in want.items():
            assert tuple(out[f"block.{name}"]) == block, name
            nbytes, own = out[f"bytes.{name}"]
            assert nbytes == own, name  # its own storage, not a view of the whole
        assert int(out["block.edges"][0]) > 0  # edges: replicated at their true length


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_mesh_training_matches_single_device(runs, shape, case):
    outs, refs, graph = runs
    base = refs["f32" if case == "resume" else case]
    table_tol = {"f64": 1e-10, "bf16": BF16_TABLE_TOL, "kernel": BF16_TABLE_TOL}.get(case, 1e-5)
    first = outs[shape][0]
    for name in ("user_emb", "item_emb"):
        got = first[f"{case}.{name}"]
        want = getattr(base.params, name).numpy()
        assert got.shape == want.shape  # unpadded to the true catalog
        assert got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=table_tol, err_msg=name)
        for out in outs[shape][1:]:  # every rank returns the same whole tables
            np.testing.assert_array_equal(out[f"{case}.{name}"], got)
    # a resumed run records the evals after its checkpoint (epoch 2) only
    rows = slice(1, None) if case == "resume" else slice(None)
    for name, series in base.history.items():
        got = first[f"{case}.history.{name}"]
        np.testing.assert_allclose(got, np.asarray(series[rows], np.float64), rtol=0,
                                   atol=2e-5, err_msg=name)
    assert list(first[f"{case}.history.iters"]) == [0, 3][rows]
    if case == "resume":  # from the mesh's own checkpoint: the uninterrupted mesh run
        for name in ("user_emb", "item_emb"):
            np.testing.assert_array_equal(first[f"resume.{name}"], first[f"f32.{name}"])


@contextlib.contextmanager
def _world_one_mesh():
    """A (1, 1) mesh of a world-1 gloo group on a file store."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{os.path.join(tmp, 's')}",
                                world_size=1, rank=0)
        try:
            yield rmesh.make_mesh((1, 1))
        finally:
            dist.destroy_process_group()


def test_sharded_train_scan_matches_per_step_path():
    """``make_sharded_train_scan`` over 4 epochs is the sharded step on each
    epoch's own generator: the same tables and last loss, bit for bit, as
    the loop of ``make_sharded_train_step`` (JAX's
    ``tests/test_sharding.py::test_sharded_train_scan_matches_per_step_path``)."""
    from lgcnhs_tpu_torch.data.graph import normalized_bipartite, pos_bool_matrix, unique_edges
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, init_lightgcn
    from lgcnhs_tpu_torch.parallel import sharding
    from lgcnhs_tpu_torch.train.trainer import epoch_generator, make_optimizer

    cfg = _cfg("f32")
    g = build_graph(load_dataset(cfg, "cpu")[0])
    U, I = g.n_users, g.n_items
    es = unique_edges(g.train)
    p0 = init_lightgcn(torch.Generator().manual_seed(2), U, I, 8)
    with _world_one_mesh() as mesh:
        plan = sharding.make_plan(mesh)
        R_blk, pos_blk, eu, ei = sharding.shard_train_inputs(
            plan, normalized_bipartite(U, I, g.train), pos_bool_matrix(U, I, g.train), es.users,
            es.items)
        args = (R_blk, eu, ei, pos_blk)
        runs = []
        for scan in (True, False):
            params = LightGCNParams(*(t.clone().requires_grad_(True)
                                      for t in sharding.shard_params(plan, p0)))
            opt = make_optimizer(cfg.hparams, params)
            if scan:
                loss = sharding.make_sharded_train_scan(plan, opt, cfg.hparams, I)(
                    params, 5, 0, 4, *args)
            else:
                step = sharding.make_sharded_train_step(plan, opt, cfg.hparams, I)
                for e in range(4):
                    loss = step(params, e, epoch_generator(5, e, mesh.device), *args)
            runs.append((loss, params))
    (loss_a, pa), (loss_b, pb) = runs
    assert torch.equal(loss_a, loss_b)
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)


def test_padded_rows_stay_zero_under_adam():
    """Padded table rows get exact zero gradients through the sharded step,
    so Adam leaves them and both its moments at zero (one rank, a (1, 1)
    mesh of a world-1 gloo group, and a catalog padded by hand)."""
    from lgcnhs_tpu_torch.data.graph import normalized_bipartite, pos_bool_matrix, unique_edges
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, init_lightgcn
    from lgcnhs_tpu_torch.parallel import sharding
    from lgcnhs_tpu_torch.train.checkpoint import optimizer_state
    from lgcnhs_tpu_torch.train.trainer import epoch_generator, make_optimizer

    cfg = _cfg("f32")
    splits, _, _ = load_dataset(cfg, "cpu")
    g = build_graph(splits)
    U, I = g.n_users, g.n_items
    es = unique_edges(g.train)
    # zero rows and columns beyond the catalog, as padded_catalog adds them
    R = np.zeros((U + 3, I + 5), np.float32)
    R[:U, :I] = normalized_bipartite(U, I, g.train)
    pos = np.ones((U + 3, I + 5), bool)
    pos[:U, :I] = pos_bool_matrix(U, I, g.train)
    with _world_one_mesh() as mesh:
        plan = sharding.make_plan(mesh)
        R_blk, pos_blk, eu, ei = sharding.shard_train_inputs(plan, R, pos, es.users, es.items)
        p0 = init_lightgcn(torch.Generator().manual_seed(1), U, I, 8)
        padded = LightGCNParams(torch.cat([p0.user_emb, torch.zeros(3, 8)]),
                                torch.cat([p0.item_emb, torch.zeros(5, 8)]))
        params = LightGCNParams(*(t.clone().requires_grad_(True)
                                  for t in sharding.shard_params(plan, padded)))
        opt = make_optimizer(cfg.hparams, params)
        step = sharding.make_sharded_train_step(plan, opt, cfg.hparams, I)
        for e in range(4):
            step(params, e, epoch_generator(0, e, torch.device("cpu")), R_blk, eu, ei, pos_blk)
        state = optimizer_state(opt, params)
    for name, t, n in (("user_emb", params.user_emb, U), ("item_emb", params.item_emb, I)):
        assert torch.count_nonzero(t[n:]) == 0
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.count_nonzero(state[name][m][n:]) == 0, (name, m)
        assert torch.count_nonzero(t[:n]) > 0

"""Kernel 4's compacted walk, on the CPU: A restricted to each 128-user
block's items (``ops/cuda/fusion_serve.compact_operands``), W's parts
N-major a block of items at a time (``fusion_serve.kernel_operands``),
the rule that picks the walk (``fusion_serve.compact_walk``), its
counters and the ``serve.contraction_share`` metric that reads them.

- ``cols`` holds each block's sorted union of items, padded with item 0 to
  a multiple of 32; ``a_cols`` scattered back is ``positive_parts``' A bit
  for bit: U off 128, I off 32 and 64, users with no rows, a block with an
  empty union, rows repeated inside and across splits, no rows at all.
- The compacted contraction (``a_cols`` @ W[cols] a block) is A @ W:
  bitwise on dyadic W, within f32 rounding on continuous W.
- The rule: dense at ML-1M's and ``chip_smoke.py`` phase 15's shapes,
  compacted at Gowalla's and Amazon-Book's.
- No host sync in the build: no ``aten._local_scalar_dense``, no copy off
  the device, no operator whose output size depends on the data, and the
  same operators and shapes for two edge sets of one size.
- The N-major W parts hold each block exactly; serving on the compacted
  walk gives the dense walk's lists and is within the benchmark's
  ``score_gap`` limit of ``portbench/reference/serve.py``.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.models import fusion
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.ops.cuda import fusion_serve as tserve
from lgcnhs_tpu_torch.ops.diffusion import edge_spreading, transfer_block
from portbench import harness, judge
from portbench.reference import serve as ref_serve
from portbench.reference.data import Split

B = tserve.BLOCK_USERS


def _es(users, items):
    return tgraph.EdgeSet(np.asarray(users, dtype=np.int32), np.asarray(items, dtype=np.int32))


def _random(seed, n, users, items, low=0):
    rng = np.random.default_rng(seed)
    return _es(rng.integers(low, users, n), rng.integers(0, items, n))


def _case(name):
    """(U, I, train, val) of a named case."""
    if name == "random":  # three blocks, the last of 44 users
        return 300, 100, _random(1, 1500, 300, 100), _random(2, 300, 300, 100)
    if name == "empty_block":  # block 1 (users 128-255) has no row; I off 32
        t, v = _random(3, 500, 300, 37), _random(4, 90, 128, 37)
        keep = (t.users < B) | (t.users >= 2 * B)
        return 300, 37, _es(t.users[keep], t.items[keep]), v
    if name == "duplicates":  # rows repeated inside the train split and across splits
        t = _random(5, 400, 200, 45)
        return (200, 45, _es(np.r_[t.users, t.users[:60]], np.r_[t.items, t.items[:60]]),
                _es(np.r_[t.users[10:90], 0], np.r_[t.items[10:90], 0]))
    if name == "sparse_users":  # most users have no row; I off 64 and past a 128-item tile
        return 260, 130, _random(6, 90, 260, 130, low=200), _random(7, 10, 40, 130)
    if name == "one_user":
        return 1, 70, _es([0, 0, 0], [69, 3, 3]), _es([0], [12])
    if name == "no_rows":
        return 130, 40, _es([], []), _es([], [])
    raise KeyError(name)


CASES = ["random", "empty_block", "duplicates", "sparse_users", "one_user", "no_rows"]


def _edges(case):
    U, I, train, val = _case(case)
    return U, I, torch.from_numpy(tgraph.edge_array(train, val))


def _unions(U, edges):
    users, items = edges[0].numpy(), edges[1].numpy()
    return [np.unique(items[users // B == b]) for b in range(-(-U // B))]


@pytest.mark.parametrize("case", CASES)
def test_cols_hold_each_blocks_sorted_union(case):
    U, I, edges = _edges(case)
    ops = tserve.compact_operands(U, I, edges)
    blocks = -(-U // B)
    bound = edges.shape[1] + 31 * blocks
    assert ops.col_ptr.dtype == ops.cols.dtype == torch.int32
    assert ops.a_cols.dtype == torch.bfloat16
    assert ops.col_ptr.shape == (blocks + 1,) and ops.cols.shape == (bound,)
    assert ops.a_cols.shape == (B * bound,)
    ptr = ops.col_ptr.tolist()
    assert ptr[0] == 0
    for b, union in enumerate(_unions(U, edges)):
        assert ptr[b + 1] - ptr[b] == -(-len(union) // 32) * 32
        got = ops.cols[ptr[b]:ptr[b + 1]].numpy()
        np.testing.assert_array_equal(got[:len(union)], union)
        assert not got[len(union):].any()  # the padding: item 0
    if case == "empty_block":
        assert ptr[2] == ptr[1]


@pytest.mark.parametrize("case", CASES)
def test_a_cols_scatter_back_to_the_positive_parts_a(case):
    U, I, edges = _edges(case)
    ops = tserve.compact_operands(U, I, edges)
    a_parts, _ = tserve.positive_parts(U, I, edges)
    want = a_parts[0, :, :I].float()
    got = tserve.compact_dense(ops, U, I)
    assert got.view(torch.int32).numpy().tobytes() == want.view(torch.int32).numpy().tobytes()
    ptr = ops.col_ptr.tolist()
    for b, union in enumerate(_unions(U, edges)):
        block = ops.a_cols[B * ptr[b]:B * ptr[b + 1]].view(B, -1).float()
        assert torch.equal(block[:, len(union):], torch.zeros_like(block[:, len(union):]))
        assert not block[U - B * b:].any()  # rows of users past U
    assert not ops.a_cols[B * ptr[-1]:].float().any()


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_compacted_contraction_is_a_w(case, dyadic):
    """Dyadic W (multiples of 1/8 below 4): every sum exact, so bitwise;
    continuous W: the same terms summed in another order."""
    U, I, edges = _edges(case)
    gen = torch.Generator().manual_seed(11)
    W = (torch.randint(0, 32, (I, I), generator=gen).float() / 8 if dyadic
         else torch.rand((I, I), generator=gen))
    A, _ = tgraph.dense_positives(U, I, edges)
    want = A @ W
    ops = tserve.compact_operands(U, I, edges)
    ptr = ops.col_ptr.tolist()
    got = torch.zeros((len(ptr) - 1) * B, I)
    for b in range(len(ptr) - 1):
        a_b = ops.a_cols[B * ptr[b]:B * ptr[b + 1]].view(B, -1).float()
        got[B * b:B * (b + 1)] = a_b @ W[ops.cols[ptr[b]:ptr[b + 1]].long()]
    got = got[:U]
    if dyadic:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("shape, compact", [
    ((6_040, 3_706, 905_236), False),  # ml1m
    ((6_040, 20_000, 600_000), False),  # chip_smoke.py phase 15
    ((29_741, 40_848, 924_735), True),  # gowalla
    ((52_583, 91_521, 2_686_468), True),  # amazonbook
])
def test_the_walk_follows_the_input_density(shape, compact):
    assert tserve.compact_walk(*shape) is compact


class _Ops(TorchDispatchMode):
    """Records each operator with its outputs' shapes and devices."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.seen.append((str(func.overloadpacket.__name__),
                          tuple((tuple(t.shape), t.device.type) for t in outs
                                if isinstance(t, torch.Tensor))))
        return out


SYNCING = {"_local_scalar_dense", "nonzero", "_unique2", "unique_dim", "unique_consecutive",
           "masked_select", "repeat_interleave", "equal", "is_nonzero", "item"}


def _recorded(fn):
    with _Ops() as ops:
        fn()
    return ops.seen


@pytest.mark.parametrize("what", ["compact_operands", "kernel_operands"])
def test_the_build_waits_for_nothing(monkeypatch, what):
    """Two edge sets of the same size and other contents: no syncing
    operator, nothing made off the edges' device, and the same operators
    with the same shapes (no size that depends on the data)."""
    monkeypatch.setattr(tserve, "compact_walk", lambda *args: True)
    monkeypatch.setattr(tserve, "W_BLOCK", 16)
    U, I, edges = _edges("random")
    other = torch.from_numpy(tgraph.edge_array(_random(8, edges.shape[1], U, I)))
    build = ((lambda e: tserve.compact_operands(U, I, e)) if what == "compact_operands"
             else (lambda e: tserve.kernel_operands(U, I, e, 0.6)))
    first, second = _recorded(lambda: build(edges)), _recorded(lambda: build(other))
    names = {name for name, _ in first}
    assert not names & SYNCING, names & SYNCING
    assert all(dev == edges.device.type for _, outs in first for _, dev in outs)
    assert first == second


@pytest.mark.parametrize("block", [5, 16, 100, 128])
def test_n_major_w_parts_hold_each_block_exactly(monkeypatch, block):
    monkeypatch.setattr(tserve, "compact_walk", lambda *args: True)
    monkeypatch.setattr(tserve, "W_BLOCK", block)
    U, I, edges = _edges("duplicates")
    a, w_parts, seen, compact, w_blocks = tserve.kernel_operands(U, I, edges, 0.6)
    assert compact and w_blocks == -(-I // block)
    ld = tserve.parts_ld(I)
    assert w_parts.shape == (3, I, ld) and w_parts.dtype == torch.bfloat16
    assert torch.equal(w_parts[:, :, I:].float(), torch.zeros(3, I, ld - I))
    A, want_seen = tgraph.dense_positives(U, I, edges)
    spread = edge_spreading(U, I, edges, 0.6)
    for j0 in range(0, I, block):
        W_cols = transfer_block(spread, A[:, j0:j0 + block], j0)
        assert torch.equal(w_parts[:, :, j0:min(j0 + block, I)].float().sum(0), W_cols)
    want = tserve.compact_operands(U, I, edges)
    assert isinstance(a, tserve.CompactOperands)
    assert all(torch.equal(x, y) for x, y in zip(a, want))
    assert torch.equal(seen, want_seen)


def test_the_dense_walk_keeps_its_operands():
    U, I, edges = _edges("random")
    assert not tserve.compact_walk(U, I, edges.shape[1])
    ops = tserve.kernel_operands(U, I, edges, 0.6)
    assert not ops.compact and ops.w_blocks == 1
    assert isinstance(ops.a, torch.Tensor) and ops.a.shape == (1, U, tserve.parts_ld(I))


def _split(graph):
    return Split(graph.n_users, graph.n_items, graph.train.users.astype(np.int64),
                 graph.train.items.astype(np.int64), graph.val.users.astype(np.int64),
                 graph.val.items.astype(np.int64))


@pytest.mark.parametrize("lam", [0.0, 0.6])
@pytest.mark.parametrize("case", ["random", "empty_block", "sparse_users"])
def test_compacted_serving_lists(monkeypatch, case, lam):
    U, I, train, val = _case(case)
    every = _es(np.r_[train.users, val.users], np.r_[train.items, val.items])
    graph = tgraph.InteractionGraph(U, I, every, train, val, _es([], []))
    cfg = tcfg.load_config(dataset="synthetic", model="SpreadLightGCN",
                           overrides={"k": 7, "hparams.lambda_": lam})
    gen = torch.Generator().manual_seed(3)
    params = LightGCNParams(0.1 * torch.randn(U, 8, generator=gen),
                            0.1 * torch.randn(I, 8, generator=gen))
    monkeypatch.setattr(fusion, "serve_route", lambda *args: "kernel")
    monkeypatch.setattr(tserve, "W_BLOCK", 16)
    dense = fusion.serve_fused(graph, cfg, params)
    monkeypatch.setattr(tserve, "compact_walk", lambda *args: True)
    got = fusion.serve_fused(graph, cfg, params)
    np.testing.assert_array_equal(got, dense)
    scores = ref_serve.fused_scores(_split(graph), params.user_emb, params.item_emb, lam,
                                    np.arange(U))
    assert judge.score_gap(got, scores) <= 1e-4


def test_counters_are_the_kernels(monkeypatch):
    f = tserve.fused_lgcnhs_serve
    for name in ("compact_launches", "k_rows", "k_rows_dense"):
        assert isinstance(getattr(f, name), int)
    U, I, edges = _edges("random")
    gen = torch.Generator().manual_seed(5)
    ue, ie = torch.randn(U, 8, generator=gen), torch.randn(I, 8, generator=gen)
    before = (f.launches, f.compact_launches, f.k_rows, f.k_rows_dense)
    dense = tserve.kernel_operands(U, I, edges, 0.6)
    monkeypatch.setattr(tserve, "compact_walk", lambda *args: True)
    compact = tserve.kernel_operands(U, I, edges, 0.6)
    assert (dense.compact, compact.compact) == (False, True)
    for ops in (dense, compact):  # off the card: the twin, no launch
        tserve.fused_serve_parts(ue, ie, ops, 5)
    assert (f.launches, f.compact_launches, f.k_rows, f.k_rows_dense) == before


def _read(counts):
    ctx = harness.Context(None, {}, {}, {}, counts)
    return harness.load_metric("serve.contraction_share").read(ctx)


@pytest.mark.parametrize("counts, want", [
    ({"k_rows": 62, "k_rows_dense": 1000}, 6.2),
    ({"k_rows": 4096, "k_rows_dense": 4096}, 100.0),  # the dense walk
    ({"k_rows": 0, "k_rows_dense": 0}, None),  # no launch in the window
    ({}, None),  # a program without the counters
])
def test_contraction_share_reads_the_counters(counts, want):
    got = _read(counts)
    assert got == (None if want is None else pytest.approx(want))


def test_k_rows_counters_resolve_to_the_program():
    reader = harness.load_metric("serve.contraction_share")
    read = {name: harness._read_counter(path) for name, path in reader.COUNTERS.items()}
    f = tserve.fused_lgcnhs_serve
    assert read == {"k_rows": f.k_rows, "k_rows_dense": f.k_rows_dense}


def test_a_program_without_the_k_rows_counters_declares_none(monkeypatch):
    monkeypatch.delattr(tserve.fused_lgcnhs_serve, "k_rows")
    assert harness.load_metric("serve.contraction_share").COUNTERS == {}

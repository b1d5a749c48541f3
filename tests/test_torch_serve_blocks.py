"""Serving's kernel operands built from the train+val edges
(``ops/cuda/fusion_serve.kernel_operands``): A's bf16 part and seen
(``fusion_serve.positive_parts``), W^T's bf16 parts a block of
``fusion_serve.W_BLOCK`` items at a time (``ops/diffusion.edge_spreading``,
``transfer_block``), on the CPU.

- The blocks' W equals ``hybrid_transfer(A, general_spreading_matrix(A), l)``
  within f32 rounding: block widths that do and do not divide I, users and
  items with no row, rows repeated inside a split and across splits, and
  l in {0, 0.6, 1}; the parts hold each block exactly.
- A's part and seen equal ``dense_positives``' A and seen bit for bit.
- No (I, I) and no (U, I) f32 or f64 array is made on the way, at blocks
  narrower than the catalog.
- ``serve_fused`` along the kernel route (the twin on the parts' sums on
  the CPU) serves lists within the benchmark's ``score_gap`` limit of the
  float64 reference (``portbench/reference/serve.py``), and the plain
  route's lists.
- One ``serve.w_block`` span a block inside ``serve.transfer_matrix``, and
  ``serve_fused.w_blocks`` up by ceil(I / b) a pass.
- ``serve.w_build_share`` reads the ``serve.w_block`` spans as
  ``serve.build_share`` reads its own.
"""
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.models import fusion
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.ops.cuda import fusion_serve as tserve
from lgcnhs_tpu_torch.ops.diffusion import (
    edge_spreading, general_spreading_matrix, hybrid_transfer, transfer_block,
)
from portbench import harness, judge
from portbench.reference import serve as ref_serve
from portbench.reference.data import Split
from portbench.trace import TraceView

U, I, D = 24, 37, 8
MS = 1_000_000  # ns


def _es(users, items):
    return tgraph.EdgeSet(np.asarray(users, dtype=np.int32), np.asarray(items, dtype=np.int32))


def _random(seed, n, users=U, items=I):
    rng = np.random.default_rng(seed)
    return _es(rng.integers(0, users, n), rng.integers(0, items, n))


def _case(name):
    """(train, val) of a named case."""
    if name == "random":
        return _random(1, 200), _random(2, 40)
    if name == "duplicates":  # repeated inside the train split and across splits
        t = _random(3, 90)
        return (_es(np.r_[t.users, t.users[:25]], np.r_[t.items, t.items[:25]]),
                _es(np.r_[t.users[10:30], 0], np.r_[t.items[10:30], 0]))
    if name == "zero_degrees":  # users U/2.. and items I/2.. have no row
        return _random(7, 120, U // 2, I // 2), _random(8, 20, U // 2, I // 2)
    raise KeyError(name)


CASES = ["random", "duplicates", "zero_degrees"]


def _graph(train, val):
    every = _es(np.r_[train.users, val.users], np.r_[train.items, val.items])
    return tgraph.InteractionGraph(U, I, every, train, val, _es([], []))


def _edges(case):
    return torch.from_numpy(tgraph.edge_array(*_case(case)))


def _cfg(lam=0.6):
    return tcfg.load_config(dataset="synthetic", model="SpreadLightGCN",
                            overrides={"k": 5, "hparams.lambda_": lam})


def _params(seed=3):
    gen = torch.Generator().manual_seed(seed)
    return LightGCNParams(0.1 * torch.randn(U, D, generator=gen),
                          0.1 * torch.randn(I, D, generator=gen))


@pytest.mark.parametrize("block", [5, 16, I, 64])
@pytest.mark.parametrize("lam", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("case", CASES)
def test_block_w_equals_the_dense_transfer(monkeypatch, case, lam, block):
    edges = _edges(case)
    A, _ = tgraph.dense_positives(U, I, edges)
    want = hybrid_transfer(A, general_spreading_matrix(A), lam)
    spread = edge_spreading(U, I, edges, lam)
    blocks = [transfer_block(spread, A[:, j0:j0 + block], j0) for j0 in range(0, I, block)]
    got = torch.cat(blocks, dim=1)
    assert got.dtype == torch.float32 and got.shape == (I, I)
    # W_gen's terms summed in another order, scaled by reciprocals: a few
    # f32 roundings of each entry, every term positive
    torch.testing.assert_close(got, want, rtol=8 * 2.0**-23, atol=0.0)
    assert torch.equal(got == 0, want == 0)

    monkeypatch.setattr(tserve, "W_BLOCK", block)
    ops = tserve.kernel_operands(U, I, edges, lam)
    w_parts, ld = ops.w_parts, tserve.parts_ld(I)
    assert not ops.compact and ops.w_blocks == len(blocks)
    assert w_parts.shape == (3, I, ld) and w_parts.dtype == torch.bfloat16
    for j0, blk in zip(range(0, I, block), blocks):  # each block exactly, rows j of W^T
        rows = w_parts[:, j0:j0 + block].float()
        assert torch.equal(rows.sum(0)[:, :I], blk.T)
        assert torch.equal(rows[:, :, I:], torch.zeros_like(rows[:, :, I:]))


@pytest.mark.parametrize("case", CASES)
def test_a_part_and_seen_equal_the_dense_build(case):
    edges = _edges(case)
    A, seen = tgraph.dense_positives(U, I, edges)
    ld = tserve.parts_ld(I)
    a_parts, got_seen = tserve.positive_parts(U, I, edges)
    assert a_parts.shape == (1, U, ld) and a_parts.dtype == torch.bfloat16
    want = tserve.bf16_parts(A, 1, ld)
    assert a_parts.view(torch.int16).numpy().tobytes() == want.view(torch.int16).numpy().tobytes()
    assert got_seen.dtype == torch.bool and torch.equal(got_seen, seen)


class _Made(TorchDispatchMode):
    """Records the shape and dtype of every dense tensor an operator makes."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor) and t.layout == torch.strided:
                self.made.append((tuple(t.shape), t.dtype))
        return out


@pytest.mark.parametrize("block", [5, 16, I - 1])
def test_no_dense_f32_array_of_the_catalog(monkeypatch, block):
    """At a block narrower than the catalog (at 4,096 items a block, every
    catalog past ML-1M's one block)."""
    edges = _edges("duplicates")
    monkeypatch.setattr(tserve, "W_BLOCK", block)
    with _Made() as made:
        a_parts, w_parts, seen, _, _ = tserve.kernel_operands(U, I, edges, 0.6)
    wide = [(shape, dtype) for shape, dtype in made.made
            if dtype in (torch.float32, torch.float64) and shape in ((I, I), (U, I))]
    assert not wide, wide
    assert ((I, block), torch.float32) in made.made  # one block's product
    ld = tserve.parts_ld(I)
    assert (a_parts.shape, w_parts.shape, seen.shape) == ((1, U, ld), (3, I, ld), (U, I))
    assert (a_parts.dtype, w_parts.dtype, seen.dtype) == (torch.bfloat16,) * 2 + (torch.bool,)


def _kernel_route(monkeypatch):
    monkeypatch.setattr(fusion, "serve_route", lambda *args: "kernel")


def _split(graph):
    return Split(graph.n_users, graph.n_items, graph.train.users.astype(np.int64),
                 graph.train.items.astype(np.int64), graph.val.users.astype(np.int64),
                 graph.val.items.astype(np.int64))


@pytest.mark.parametrize("lam", [0.0, 0.6, 1.0])
@pytest.mark.parametrize("case", CASES)
def test_kernel_route_lists_match_the_reference(monkeypatch, case, lam):
    graph, cfg, params = _graph(*_case(case)), _cfg(lam), _params()
    plain = fusion.serve_fused(graph, cfg, params)
    _kernel_route(monkeypatch)
    monkeypatch.setattr(tserve, "W_BLOCK", 16)
    got = fusion.serve_fused(graph, cfg, params)
    assert got.shape == (U, cfg.k) and got.dtype == np.int32
    users = np.arange(U)
    scores = ref_serve.fused_scores(_split(graph), params.user_emb, params.item_emb, lam, users)
    assert judge.score_gap(got, scores) <= 1e-4
    assert judge.score_gap(plain, scores) <= 1e-4


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [ev for ev in prof.events() if ev.name.startswith("serve.")]


def _parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("serve."):
        p = p.cpu_parent
    return None if p is None else p.name


@pytest.mark.parametrize("block", [5, 16, I, 64])
def test_w_block_spans_and_counter(monkeypatch, block):
    graph, cfg, params = _graph(*_case("random")), _cfg(), _params()
    _kernel_route(monkeypatch)
    monkeypatch.setattr(tserve, "W_BLOCK", block)
    blocks = -(-I // block)
    before = (fusion.serve_fused.w_blocks, tserve.fused_lgcnhs_serve.split_launches)
    _, events = _profiled(lambda: fusion.serve_fused(graph, cfg, params))
    assert fusion.serve_fused.w_blocks == before[0] + blocks
    assert tserve.fused_lgcnhs_serve.split_launches == before[1]  # none off the card
    names = Counter(ev.name for ev in events)
    assert names == {"serve.pass": 1, "serve.build": 2, "serve.upload": 1,
                     "serve.transfer_matrix": 1, "serve.w_block": blocks, "serve.rank": 1,
                     "serve.download": 1}
    assert all(_parent(ev) == "serve.transfer_matrix"
               for ev in events if ev.name == "serve.w_block")
    fusion.serve_fused(graph, cfg, params)  # without a session: counted all the same
    assert fusion.serve_fused.w_blocks == before[0] + 2 * blocks


def _read(name, view, counts=None):
    ctx = harness.Context(view, {}, {}, {}, counts or {})
    return harness.load_metric(name).read(ctx)


def test_w_build_share_over_the_passes_in_the_window():
    """Two passes inside a 0-100 ms window (0-40, 50-90), a third cut by its
    end; W blocks 20-26 and 26-30 in the first, 60-70 in the second, 95-99
    in the third."""
    host = [("serve.pass", 0, 40 * MS), ("serve.transfer_matrix", 18 * MS, 30 * MS),
            ("serve.w_block", 20 * MS, 26 * MS), ("serve.w_block", 26 * MS, 30 * MS),
            ("serve.pass", 50 * MS, 90 * MS), ("serve.w_block", 60 * MS, 70 * MS),
            ("serve.pass", 92 * MS, 110 * MS), ("serve.w_block", 95 * MS, 99 * MS)]
    view = TraceView((0, 100 * MS), [("sgemm", 20 * MS, 30 * MS)], host)
    counts = {"w_blocks": 4}
    assert _read("serve.w_build_share", view, counts) == pytest.approx(100 * 20 / 80)
    assert _read("serve.w_build_share", view, {"w_blocks": 0}) is None
    assert _read("serve.w_build_share", view) is None  # a program without the counter


@pytest.mark.parametrize("host", [
    [("serve.pass", 0, 40 * MS), ("serve.build", 0, 10 * MS)],  # a pass without W blocks
    [("aten::mm", 0, 9 * MS)],  # no span at all
    [("serve.pass", 10 * MS, 60 * MS), ("serve.w_block", 20 * MS, 30 * MS)],  # cut by the end
])
def test_w_build_share_without_its_spans(host):
    view = TraceView((0, 50 * MS), [("k", 0, 1 * MS)], host)
    got = _read("serve.w_build_share", view, {"w_blocks": 1})
    assert got is None or got == 0.0
    if not any(name == "serve.pass" and e <= 50 * MS for name, _, e in host):
        assert got is None


def test_w_block_counter_resolves_to_the_program():
    reader = harness.load_metric("serve.w_build_share")
    read = {name: harness._read_counter(path) for name, path in reader.COUNTERS.items()}
    assert read == {"w_blocks": fusion.serve_fused.w_blocks}


def test_a_program_without_the_counter_declares_none(monkeypatch):
    monkeypatch.delattr(fusion.serve_fused, "w_blocks")
    assert harness.load_metric("serve.w_build_share").COUNTERS == {}

"""The edge-list propagation of ``lgcnhs_tpu_torch/ops/cuda/segment_propagation``
on the CPU: its graph and chunk plan against numpy, its twin and layer mean
against the port's other layouts and the JAX package, its self-adjoint
backward against autograd, the trainer's COO route choosing it, and the
``segment_pair_roofline`` reader. The kernel itself runs on the card only
(``chip_smoke.py`` phase 17).

Tolerances: propagation within 1e-12 under x64 and 1e-5 relative at f32
(sums in another order), as ``tests/test_torch_coo.py``; gradients within
1e-12 relative of autograd at f64; the trained runs at
``tests/test_torch_large_train.py``'s.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_coo import U, I, D, _skewed_edges, _t, _tables, x64  # noqa: E402
from test_torch_large_train import (  # noqa: E402
    _assert_runs_match, _graph_pair, _inject_csr, _overrides, _train_both,
)

from lgcnhs_tpu.ops import propagation as jprop
from lgcnhs_tpu_torch.ops import propagation as tprop
from lgcnhs_tpu_torch.ops.cuda import segment_propagation as seg
from lgcnhs_tpu_torch.train import trainer as ttrainer
from portbench import harness
from portbench.trace import TraceView


def _graph(seed, w_dtype=None):
    """(edges, weights, SegmentGraph) of the skewed graph: item 0 has 147
    users, user 0 every item, a few nodes no edge."""
    eu, ei = _skewed_edges(seed)
    norm = tprop.edge_gcn_norm(_t(eu), _t(ei), U, I)
    if w_dtype is not None:
        norm = torch.from_numpy(
            (np.random.default_rng(seed + 1).random(eu.shape[0]) + 0.1).astype(w_dtype))
    return eu, ei, norm, seg.build_segment_graph(_t(eu), _t(ei), norm, U, I)


def _numpy_plan(rowptr, chunk):
    units, splits, slot = [], [], 0
    for r in range(rowptr.shape[0] - 1):
        lo, hi = int(rowptr[r]), int(rowptr[r + 1])
        n = max(1, -(-(hi - lo) // chunk))
        split = hi - lo > chunk
        for c in range(n):
            units.append((r, lo + c * chunk, min(lo + (c + 1) * chunk, hi),
                          slot + c if split else -1))
        if split:
            splits.append((r, slot, n, 0))
            slot += n
    units.sort(key=lambda u: u[1] - u[2])  # longest first, stable
    return (np.array(units, np.int32).reshape(-1, 4), np.array(splits, np.int32).reshape(-1, 4),
            slot)


def test_segment_graph_arrays_match_numpy():
    eu, ei, norm, csr = _graph(1)
    E = eu.shape[0]
    assert (csr.n_users, csr.n_items, csr.n_edges) == (U, I, E)
    assert csr.rowptr.dtype == csr.cols.dtype == csr.units.dtype == torch.int32
    assert csr.w.dtype == torch.float32
    pu, pi = np.argsort(eu, kind="stable"), np.argsort(ei, kind="stable")
    deg = np.r_[np.bincount(eu, minlength=U), np.bincount(ei, minlength=I)]
    np.testing.assert_array_equal(csr.rowptr.numpy(), np.r_[0, np.cumsum(deg)])
    np.testing.assert_array_equal(csr.cols.numpy(), np.r_[ei[pu], eu[pi]])
    np.testing.assert_array_equal(csr.w.numpy(), np.r_[norm.numpy()[pu], norm.numpy()[pi]])
    units, splits, n_slots = _numpy_plan(csr.rowptr.numpy(), seg.CHUNK)
    np.testing.assert_array_equal(csr.units.numpy(), units)
    np.testing.assert_array_equal(csr.splits.numpy(), splits)
    assert csr.n_slots == n_slots
    assert (deg == 0).any()  # empty rows


@pytest.mark.parametrize("chunk", [1, 3, 8, 128, seg.CHUNK])
def test_chunk_plan_matches_numpy_and_covers_every_edge_once(chunk):
    _, _, _, csr = _graph(2)
    units, splits, n_slots = seg.chunk_plan(csr.rowptr, chunk)
    want = _numpy_plan(csr.rowptr.numpy(), chunk)
    np.testing.assert_array_equal(units.numpy(), want[0])
    np.testing.assert_array_equal(splits.numpy(), want[1])
    assert n_slots == want[2]
    covered = np.zeros(csr.cols.shape[0], np.int64)
    for _, lo, hi, _ in units.numpy():
        covered[lo:hi] += 1
    assert (covered == 1).all()
    # every row written once: by its one unit, or by its entry in splits
    direct = units.numpy()[units.numpy()[:, 3] < 0, 0]
    rows = np.sort(np.r_[direct, splits.numpy()[:, 0]])
    np.testing.assert_array_equal(rows, np.arange(U + I))


def _plan_emulation(csr, x_u, x_i, chunk):
    """The kernel's sums as its plan orders them, in float64: each unit's
    edges in order, a split row's partials in chunk order."""
    units, splits, n_slots = seg.chunk_plan(csr.rowptr, chunk)
    cols, w = csr.cols.long(), csr.w.double()
    out = torch.zeros((U + I, x_u.shape[1]), dtype=torch.float64)
    ws = torch.zeros((n_slots, x_u.shape[1]), dtype=torch.float64)
    for row, lo, hi, slot in units.tolist():
        x = x_i if row < U else x_u
        acc = torch.zeros(x_u.shape[1], dtype=torch.float64)
        for e in range(lo, hi):
            acc = acc + w[e] * x[cols[e]]
        (ws[slot] if slot >= 0 else out[row]).copy_(acc)
    for row, slot0, n, _ in splits.tolist():
        acc = ws[slot0].clone()
        for c in range(1, n):
            acc = acc + ws[slot0 + c]
        out[row] = acc
    return out[:U], out[U:]


@pytest.mark.parametrize("chunk", [5, 128, seg.CHUNK])
def test_the_plans_sums_equal_the_twin(chunk):
    """The split path (a row longer than the chunk), empty rows and isolated
    nodes: the plan's sums against the twin at f64."""
    _, _, _, csr = _graph(3)
    x_u, x_i = (torch.from_numpy(t) for t in _tables(4, np.float64))
    got = _plan_emulation(csr, x_u, x_i, chunk)
    want = seg.segment_pair_ref(csr, x_u, x_i)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-12)
    assert (torch.diff(csr.rowptr) == 0).any()  # empty rows


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_propagation_matches_the_other_layouts_and_jax(dtype):
    np_dtype = np.float64 if dtype == "float64" else np.float32
    eu, ei, w, csr = _graph(5, np_dtype)
    ue, ie = _tables(6, np_dtype)
    with x64(dtype == "float64"):
        want = jprop.lightgcn_propagate_bucketed(
            jnp.asarray(ue), jnp.asarray(ie), jprop.build_bucketed_incidence(eu, ei, w.numpy(),
                                                                           U, I), 3)
        want = [np.asarray(x) for x in want]
    tu, ti = torch.from_numpy(ue), torch.from_numpy(ie)
    order = tprop.build_edge_ordering(_t(eu), _t(ei), w)
    runs = {
        "segments": seg.lightgcn_propagate_segments(tu, ti, csr, 3),
        "operand": csr.propagate(tu, ti, 3),
        "bucketed": tprop.lightgcn_propagate_bucketed(
            tu, ti, tprop.build_bucketed_incidence(eu, ei, w.numpy(), U, I), 3),
        "coo_sorted": tprop.lightgcn_propagate_coo_sorted(tu, ti, order, U, I, 3),
    }
    for name, got in runs.items():
        for g, j in zip(got, want):
            assert g.dtype == torch.from_numpy(ue).dtype, name
            if dtype == "float64":
                np.testing.assert_allclose(g.numpy(), j, rtol=0, atol=1e-12, err_msg=name)
            else:
                np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=1e-5 * np.abs(j).max(),
                                           err_msg=name)
    # the twin's pair is the sorted-segment pair, bit for bit
    pair = tprop.sorted_pair(order, U, I)
    for a, b in zip(seg.segment_pair(csr, tu, ti), pair(tu, ti)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_layers", [0, 1, 3])
def test_layer_mean_is_the_layer_mean_of_the_pair(n_layers):
    """``lightgcn_propagate_segments`` against ``ops/propagation.layer_mean``
    over the twin's pair, bit for bit (the same adds and scale)."""
    _, _, _, csr = _graph(7)
    tu, ti = (torch.from_numpy(t) for t in _tables(8, np.float32))
    got = seg.lightgcn_propagate_segments(tu, ti, csr, n_layers)
    want = tprop.layer_mean(lambda a, b: seg.segment_pair_ref(csr, a, b), tu, ti, n_layers)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_self_adjoint_backward_matches_autograd_through_the_bucketed_route():
    eu, ei, w, csr = _graph(9, np.float64)
    binc = tprop.build_bucketed_incidence(eu, ei, w.numpy(), U, I)
    rng = np.random.default_rng(11)
    cot_u, cot_i = (torch.from_numpy(rng.standard_normal(s)) for s in ((U, D), (I, D)))
    grads = []
    for run in ("segments", "bucketed"):
        ue, ie = (torch.from_numpy(t).requires_grad_(True) for t in _tables(12, np.float64))
        if run == "segments":
            out = seg.lightgcn_propagate_segments(ue, ie, csr, 3)
        else:  # autograd through layer_mean and the bucketed pair's own backward
            out = tprop.lightgcn_propagate_bucketed(ue, ie, binc, 3)
        loss = (out[0] * cot_u).sum() + (out[1] * cot_i).sum() + (out[0] ** 2).sum()
        grads.append(torch.autograd.grad(loss, (ue, ie)))
    for g, want in zip(*grads):
        torch.testing.assert_close(g, want, rtol=1e-12, atol=1e-12)

    keep = (eu < 20) & (ei < 15)
    small = seg.build_segment_graph(_t(eu[keep]), _t(ei[keep]), w[torch.from_numpy(keep)], 20, 15)
    x_u = torch.from_numpy(rng.standard_normal((20, 3))).requires_grad_(True)
    x_i = torch.from_numpy(rng.standard_normal((15, 3))).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda a, b: seg.lightgcn_propagate_segments(a, b, small, 2), (x_u, x_i))


def test_wrappers_refuse_bad_shapes():
    _, _, _, csr = _graph(13)
    tu, ti = (torch.from_numpy(t) for t in _tables(14, np.float32))
    with pytest.raises(ValueError, match="do not fit"):
        seg.lightgcn_propagate_segments(ti, tu, csr, 3)
    with pytest.raises(ValueError, match="cuda tensors"):
        seg._launch(csr, tu, ti, None, None, None, None, None, None, 1.0)


def _spy(monkeypatch, name, into):
    fn = getattr(ttrainer, name)
    monkeypatch.setattr(ttrainer, name, lambda *a, **kw: into.append(name) or fn(*a, **kw))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_coo_route_with_kernels_takes_the_segment_operand(monkeypatch, dtype):
    """With ``uses_kernels`` true (patched: on the CPU it is false) the COO
    route builds the ``SegmentGraph`` and trains through its propagation,
    the twin here; the run matches the JAX trainer's as the bucketed route
    does (``test_torch_large_train.test_coo_route_matches_jax``). f64
    tables keep the bucketed layout (the kernel is f32)."""
    graphs = _graph_pair()
    _inject_csr(monkeypatch, graphs[1], np.float64 if dtype == "float64" else np.float32)
    built = []
    _spy(monkeypatch, "build_segment_graph", built)
    _spy(monkeypatch, "build_bucketed_incidence", built)
    monkeypatch.setattr(ttrainer, "uses_kernels", lambda compute, device: True)
    got, want = _train_both(graphs, _overrides(dtype, **{"compute.dense_threshold": 1.0}),
                            x64=dtype == "float64")
    assert built == (["build_segment_graph"] if dtype == "float32"
                     else ["build_bucketed_incidence"])
    _assert_runs_match(got, want, 1e-7 if dtype == "float64" else 1e-5)


def test_coo_route_on_the_cpu_keeps_the_bucketed_layout(monkeypatch):
    graphs = _graph_pair()
    _inject_csr(monkeypatch, graphs[1], np.float32)
    built = []
    _spy(monkeypatch, "build_segment_graph", built)
    _spy(monkeypatch, "build_bucketed_incidence", built)
    _train_both(graphs, _overrides("float32", **{"compute.dense_threshold": 1.0}))
    assert built == ["build_bucketed_incidence"]


GOWALLA = {"U": 29741, "I": 40848, "nnz": 821987, "D": 64, "L": 3, "k": 100, "batch": 1024}


def test_segment_pair_count_at_gowalla():
    m = harness.load_metric("segment_pair_roofline")
    flops, nbytes = m.work(GOWALLA)
    assert flops == 4 * 821987 * 64
    # the edge list 6,575,896 B; the tables read 18,070,784 B and written as much
    assert nbytes == 8 * 821987 + 2 * (29741 + 40848) * 64 * 4 == 42_717_464
    assert m.least_seconds(GOWALLA, harness.peaks()) == pytest.approx(42_717_464 / 3.35e12)


def test_segment_pair_roofline_reads_the_launches_and_refuses_a_mismatch():
    us = 1_000
    ops = [("void (anonymous namespace)::segment_pair_kernel<2>(...)", i * 1000 * us,
            i * 1000 * us + 80 * us) for i in range(6)]
    ops += [("void (anonymous namespace)::segment_pair_reduce_kernel<2>(...)", 7000 * us,
             7000 * us + 3 * us), ("void dual_kernel<signed char>(...)", 8000 * us, 8001 * us)]
    view = TraceView((0, 10_000 * us), ops)
    m = harness.load_metric("segment_pair_roofline")

    def ctx(n):
        return harness.Context(view, {}, GOWALLA, harness.peaks(), {"segment_pair": n})

    per_launch = (6 * 80e-6 + 3e-6) / 6
    assert m.read(ctx(6)) == pytest.approx(100 * 42_717_464 / 3.35e12 / per_launch)
    assert m.read(ctx(5)) is None and m.read(ctx(0)) is None
    assert m.read(harness.Context(view, {}, GOWALLA, harness.peaks(), {})) is None


def test_segment_pair_counter_resolves_to_the_program():
    reader = harness.load_metric("segment_pair_roofline")
    assert {k: harness._read_counter(p) for k, p in reader.COUNTERS.items()} == \
        {"segment_pair": seg.segment_pair.launches}


def test_a_program_without_the_kernel_declares_no_counter(monkeypatch):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == seg.__name__ else real(name, *a))
    assert harness.load_metric("segment_pair_roofline").COUNTERS == {}

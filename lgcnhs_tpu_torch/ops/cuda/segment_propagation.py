"""LightGCN propagation over the edge list sorted by destination: one
hand-written CUDA launch a layer (``segment_propagation.cu``, which explains
the design and its bound).

It replaces no Pallas kernel: the JAX package's large-graph (COO) route is
XLA gathers and segment sums. On the card the port ran that route as
library calls over the bucketed-ELL layout (``ops/propagation``), ~300
launches a layer's pair; the single-device COO training route runs this
kernel instead (``train/trainer.train_lightgcn``).

Contract of ``segment_pair(csr, x_u, x_i) -> (A x_i, A^T x_u)``, shared by
the kernel and its plain twin ``segment_pair_ref``: A = D_u^-1/2 R
D_i^-1/2 as ``csr``'s weights hold it (``edge_gcn_norm``), each node's
messages summed over its edges. The kernel takes f32 tables and weights
and sums in f32 (fmaf in edge order, then a long row's chunks in order: a
fixed order, no atomics); the twin sums each segment in edge order
(``torch.segment_reduce``, the ``ops/propagation.sorted_pair`` math) at the
tables' precision. ``lightgcn_propagate_segments`` is the layer mean over K
layers with the self-adjoint backward: the joint operator [[0, A],
[A^T, 0]] is symmetric, so the mean s * sum_k P^k is too, and the
gradient is the same K launches on the output gradients. Each layer's
launch also adds its output into the running sum (``acc``), the last one
scaled by 1 / (K + 1).

The wrappers given CPU tensors run the twin; given CUDA tensors they launch
the kernel or raise. ``segment_pair.launches`` counts the launches,
``segment_pair.reduce_launches`` those that also ran the second kernel,
the sum of a long row's chunks; a launch captured into a CUDA graph counts
at each replay (``ops/cuda/launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from lgcnhs_tpu_torch.ops.cuda import build
from lgcnhs_tpu_torch.ops.cuda.launches import count_launch
from lgcnhs_tpu_torch.ops.propagation import _segment_sum, build_edge_ordering, layer_mean

# Edges of one unit of the chunk plan: a row up to CHUNK edges long is one
# warp's, a longer one ceil(deg / CHUNK) warps'. At Gowalla's graph a launch
# took 99.4, 87.6, 80.6, 78.4, 76.9 and 100.3 us at 64, 128, 256, 384, 512
# and 768 (H100 80GB HBM3, 700 W): short units cost their chunk sums, long
# ones become the launch's critical path; 256 keeps that path well short
# of a launch on smaller graphs too.
CHUNK = 256

_LIB = "segment_propagation"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_INT32_MAX = 2**31 - 1


class SegmentGraph(NamedTuple):
    """The weighted bipartite graph sorted by destination, on its device:
    rows 0..U-1 are the users (their item neighbours), rows U..U+I-1 the
    items (their users), each row's edges contiguous in input order; and
    the chunk plan over those rows. Built once per graph by
    ``build_segment_graph``."""

    n_users: int
    n_items: int
    n_edges: int  # E: cols[:E] are the users' rows, cols[E:] the items'
    rowptr: torch.Tensor  # (U + I + 1,) int32
    cols: torch.Tensor  # (2E,) int32 neighbour ids
    w: torch.Tensor  # (2E,) edge weights (f32 from edge_gcn_norm)
    units: torch.Tensor  # (n_units, 4) int32 (row, first edge, end edge, slot or -1)
    splits: torch.Tensor  # (n_splits, 4) int32 (row, first slot, chunks, 0)
    n_slots: int  # workspace rows: the split rows' chunks

    def propagate(self, user_emb: torch.Tensor, item_emb: torch.Tensor,
                  n_layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layer mean over this graph (``lightgcn_propagate_segments``)."""
        return lightgcn_propagate_segments(user_emb, item_emb, self, n_layers)


def chunk_plan(rowptr: torch.Tensor, chunk: int = CHUNK):
    """(units, splits, n_slots) of rows with these row pointers, on their
    device. Each row is ``max(1, ceil(deg / chunk))`` units of consecutive
    edges (a row with no edge one empty unit, so that it is written); a row
    longer than ``chunk`` has its units' partial sums in workspace rows
    ``slot0 .. slot0 + chunks - 1`` and one entry in ``splits``. Units are
    ordered longest first (stably), so the long ones start first."""
    rowptr = rowptr.long()
    dev = rowptr.device
    deg = rowptr[1:] - rowptr[:-1]
    n = torch.clamp((deg + chunk - 1) // chunk, min=1)
    split = deg > chunk
    rows = torch.repeat_interleave(torch.arange(deg.numel(), device=dev), n)
    c = torch.arange(rows.numel(), device=dev) - (torch.cumsum(n, 0) - n)[rows]
    start = rowptr[rows] + c * chunk
    end = torch.minimum(start + chunk, rowptr[rows + 1])
    n_split = torch.where(split, n, torch.zeros_like(n))
    slot0 = torch.cumsum(n_split, 0) - n_split
    slot = torch.where(split[rows], slot0[rows] + c, torch.full_like(c, -1))
    order = torch.argsort(end - start, descending=True, stable=True)
    units = torch.stack([rows, start, end, slot], 1)[order].to(torch.int32).contiguous()
    srows = torch.nonzero(split).flatten()
    splits = torch.stack([srows, slot0[srows], n[srows], torch.zeros_like(srows)], 1)
    return units, splits.to(torch.int32).contiguous(), int(n_split.sum())


def build_segment_graph(edge_users: torch.Tensor, edge_items: torch.Tensor,
                        edge_norm: torch.Tensor, n_users: int, n_items: int) -> SegmentGraph:
    """The (deduped) weighted edge list sorted by user and by item, stably
    (``build_edge_ordering``), as int32 row pointers and columns, the
    weights in their dtype, and the chunk plan (``chunk_plan``), on the
    edges' device."""
    E = int(edge_users.numel())
    if 2 * E > _INT32_MAX or n_users + n_items > _INT32_MAX:
        raise ValueError(f"segment_pair indexes edges and rows in int32: {E} edges, "
                         f"{n_users} + {n_items} rows")
    order = build_edge_ordering(edge_users, edge_items, edge_norm)
    deg = torch.cat([torch.bincount(order.eu_by_u, minlength=n_users),
                     torch.bincount(order.ei_by_i, minlength=n_items)])
    rowptr = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])
    units, splits, n_slots = chunk_plan(rowptr)
    return SegmentGraph(n_users, n_items, E, rowptr.to(torch.int32),
                        torch.cat([order.ei_by_u, order.eu_by_i]).to(torch.int32),
                        torch.cat([order.norm_by_u, order.norm_by_i]), units, splits, n_slots)


def segment_pair_ref(csr: SegmentGraph, x_u: torch.Tensor,
                     x_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin, on any device: each side gathers the other and sums
    its segments in edge order (``ops/propagation.sorted_pair``); the
    weights are promoted to the tables' dtype."""
    E, U = csr.n_edges, csr.n_users
    lengths = (csr.rowptr[1:] - csr.rowptr[:-1]).long()
    cols = csr.cols.long()
    return (_segment_sum(x_i[cols[:E]] * csr.w[:E, None], lengths[:U]),
            _segment_sum(x_u[cols[E:]] * csr.w[E:, None], lengths[U:]))


def _check_args(csr: SegmentGraph, x_u, x_i) -> None:
    U, I = csr.n_users, csr.n_items
    if x_u.dim() != 2 or x_i.dim() != 2 or x_u.shape[0] != U or x_i.shape[0] != I \
            or x_u.shape[1] != x_i.shape[1]:
        raise ValueError(f"segment_pair: tables {tuple(x_u.shape)}, {tuple(x_i.shape)} do not "
                         f"fit a graph of {U} users and {I} items")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernel's vector
    loads), copied only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _library():
    """The library, its launcher's C types bound once."""
    lib = build.load_library(_LIB)
    lib.segment_pair_launch.argtypes = [_PTR, _PTR, _INT, _INT, _PTR, _PTR, _PTR, _INT, _PTR,
                                        _INT, _PTR] + [_PTR] * 6 + [ctypes.c_float, _PTR]
    lib.segment_pair_launch.restype = _INT
    return lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(csr: SegmentGraph, x_u, x_i, out_u, out_i, acc_in_u, acc_in_i, acc_u, acc_i,
            scale: float) -> None:
    """One launch of the pair on CUDA tensors: ``out_*`` = the pair where
    given, ``acc_* = (acc_in_* + pair) * scale`` where given."""
    _check_args(csr, x_u, x_i)
    dev = x_u.device
    if dev.type != "cuda":
        raise ValueError(f"segment_pair: the kernel takes cuda tensors, got {dev}")
    for name, t in (("x_i", x_i), ("cols", csr.cols), ("w", csr.w), ("units", csr.units)):
        if t.device != dev:
            raise ValueError(f"segment_pair: {name} is on {t.device}, x_u on {dev}")
    if x_u.dtype != torch.float32 or x_i.dtype != torch.float32 or csr.w.dtype != torch.float32:
        raise ValueError(f"segment_pair: the kernel takes float32 tables and weights (got "
                         f"{x_u.dtype}, {x_i.dtype}, {csr.w.dtype})")
    ws = None
    n_splits = csr.splits.shape[0]
    if n_splits:
        ws = torch.empty((csr.n_slots, x_u.shape[1]), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.segment_pair_launch(
            x_u.data_ptr(), x_i.data_ptr(), csr.n_users, x_u.shape[1], csr.cols.data_ptr(),
            csr.w.data_ptr(), csr.units.data_ptr(), csr.units.shape[0], csr.splits.data_ptr(),
            n_splits, _ptr(ws), _ptr(out_u), _ptr(out_i), _ptr(acc_in_u), _ptr(acc_in_i),
            _ptr(acc_u), _ptr(acc_i), scale, torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(lib, rc, "segment_pair")
    count_launch(segment_pair)
    if n_splits:
        count_launch(segment_pair, "reduce_launches")


def segment_pair(csr: SegmentGraph, x_u: torch.Tensor,
                 x_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A x_i, A^T x_u): one kernel launch for CUDA tensors (f32), the twin
    for CPU tensors. No backward of its own."""
    if x_u.device.type == "cpu":
        return segment_pair_ref(csr, x_u, x_i)
    x_u, x_i = _aligned(x_u), _aligned(x_i)
    out_u, out_i = torch.empty_like(x_u), torch.empty_like(x_i)
    _launch(csr, x_u, x_i, out_u, out_i, None, None, None, None, 1.0)
    return out_u, out_i


segment_pair.launches = 0
segment_pair.reduce_launches = 0


def _layer_mean(csr: SegmentGraph, x_u: torch.Tensor, x_i: torch.Tensor,
                n_layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """s * sum_{k=0..K} P^k (x_u, x_i), s = 1 / (K + 1), as
    ``ops/propagation.layer_mean`` sums it (acc + out a layer, times s at
    the end). On CUDA one launch a layer, the running sum in its epilogue
    and the last layer's output not written."""
    if x_u.device.type == "cpu":
        return layer_mean(lambda a, b: segment_pair_ref(csr, a, b), x_u, x_i, n_layers)
    scale = 1.0 / (n_layers + 1)
    eu, ei = _aligned(x_u), _aligned(x_i)
    if n_layers == 0:
        return eu * scale, ei * scale
    acc_u, acc_i = torch.empty_like(eu), torch.empty_like(ei)
    acc_in = (eu, ei)
    for k in range(n_layers):
        last = k == n_layers - 1
        out_u, out_i = (None, None) if last else (torch.empty_like(eu), torch.empty_like(ei))
        _launch(csr, eu, ei, out_u, out_i, *acc_in, acc_u, acc_i, scale if last else 1.0)
        eu, ei, acc_in = out_u, out_i, (acc_u, acc_i)
    return acc_u, acc_i


class _Segments(torch.autograd.Function):
    """The layer mean with the self-adjoint backward: the gradient is the
    same layer mean of the output gradients. Nothing is saved but the
    graph."""

    @staticmethod
    def forward(ctx, csr: SegmentGraph, n_layers: int, user_emb, item_emb):
        ctx.csr, ctx.n_layers = csr, n_layers
        return _layer_mean(csr, user_emb, item_emb, n_layers)

    @staticmethod
    def backward(ctx, g_u, g_i):
        return (None, None, *_layer_mean(ctx.csr, g_u, g_i, ctx.n_layers))


def lightgcn_propagate_segments(user_emb: torch.Tensor, item_emb: torch.Tensor,
                                csr: SegmentGraph,
                                n_layers: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e_u^final, e_i^final), the per-side layer mean over K layers
    (``model/LightGCN/model.py:60-72``), the math of
    ``ops/propagation.lightgcn_propagate_coo_sorted``: K kernel launches
    forward and K backward on CUDA (f32), the twin on the CPU."""
    _check_args(csr, user_emb, item_emb)
    return _Segments.apply(csr, n_layers, user_emb, item_emb)

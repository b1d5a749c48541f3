"""LightGCN K-layer graph propagation: dense, COO and bucketed ELL.

Port of ``lgcnhs_tpu/ops/propagation.py``. The joint (U+I)-node graph is
bipartite, so with R_hat = D_u^-1/2 R D_i^-1/2 one propagation step is

    e_u' = R_hat   . e_i
    e_i' = R_hat^T . e_u

and the final embedding is the mean over layers 0..K
(``model/LightGCN/model.py:60-72``). Three execution paths:

- dense (``lightgcn_propagate``): R_hat as a (U, I) matrix;
- COO (``lightgcn_propagate_coo``): the per-edge weights of
  ``edge_gcn_norm`` scattered with ``index_add_``, the JAX ``segment_sum``;
  the large-graph val loss runs it;
- bucketed ELL (``build_bucketed_incidence``, ``lightgcn_propagate_bucketed``):
  nodes grouped by quantized degree into padded neighbor matrices,
  aggregated by gathers and dense sums, with the self-adjoint backward
  (``SelfAdjointPair``), so neither pass scatters over the edge list; the
  large-graph (COO) train step runs it where the ``segment_pair`` kernel
  (``ops/cuda/segment_propagation``) does not: the CPU, ``use_pallas``
  off, f64 tables. The layout exists for the TPU's gather and scatter
  costs (``docs/PERF.md``, "Large-graph (COO) training"); it is ported for
  parity, arrays identical to JAX's.

- sorted segments (``build_edge_ordering``, ``lightgcn_propagate_coo_sorted``):
  the edge list kept sorted by user and by item, each node's messages
  summed as one contiguous segment by ``torch.segment_reduce`` in edge
  order (a fixed order on the CPU and the card), with the self-adjoint
  backward; the mesh's "segment" layout
  (``parallel/sharding._coo_propagate_sharded``) runs it on each rank's
  edge block.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from lgcnhs_tpu_torch.data.graph import degree_inv_sqrt


def lightgcn_propagate(
    user_emb: torch.Tensor,  # (U, D) e_u^0
    item_emb: torch.Tensor,  # (I, D) e_i^0
    R_hat: torch.Tensor,  # (U, I) normalized bipartite incidence
    n_layers: int = 3,
    bf16_matmul: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e_u^final, e_i^final), the per-side layer mean.

    Without ``bf16_matmul`` every product runs at the operands' precision
    (f32 or f64; f32 matmuls on the card need TF32 off, the port's
    default). With it, the mixed-precision flavor of the JAX function
    (``preferred_element_type=f32``): R_hat and each layer's right operand
    are rounded to bf16, the products (exact in f32) summed in f32, and the
    result f32. ``torch.matmul`` of two bf16 tensors would round its output
    to bf16, so the bf16-valued operands are widened to f32 first."""
    eu, ei = user_emb, item_emb
    acc_u, acc_i = eu, ei
    if bf16_matmul:
        Rl = R_hat.to(torch.bfloat16).float()

        def dot(a, b):
            return a @ b.to(torch.bfloat16).float()
    else:
        Rl = R_hat

        def dot(a, b):
            return a @ b
    for _ in range(n_layers):
        eu, ei = dot(Rl, ei), dot(Rl.T, eu)
        acc_u = acc_u + eu
        acc_i = acc_i + ei
    scale = 1.0 / (n_layers + 1)
    return acc_u * scale, acc_i * scale


def lightgcn_propagate_coo(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    edge_users: torch.Tensor,  # (E,) int
    edge_items: torch.Tensor,  # (E,) int
    edge_norm: torch.Tensor,  # (E,) 1/sqrt(d_u d_i) per edge
    n_users: int,
    n_items: int,
    n_layers: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-sum forward: the dense path's math over the edge list, each
    layer's messages summed into their nodes by ``index_add_`` (in no fixed
    order on CUDA). The weights are promoted to the tables' dtype."""
    w = edge_norm[:, None]

    def pair(x_u, x_i):
        msg_u = torch.zeros((n_users, x_i.shape[1]), dtype=x_i.dtype, device=x_i.device)
        msg_i = torch.zeros((n_items, x_u.shape[1]), dtype=x_u.dtype, device=x_u.device)
        return (msg_u.index_add_(0, edge_users, x_i[edge_items] * w),
                msg_i.index_add_(0, edge_items, x_u[edge_users] * w))

    return layer_mean(pair, user_emb, item_emb, n_layers)


class SelfAdjointPair(torch.autograd.Function):
    """A linear bipartite pair ``(x_u, x_i) -> (A x_i, A^T x_u)`` with the
    self-adjoint backward of the JAX ``_self_adjoint_pair`` custom VJP: the
    joint operator [[0, A], [A^T, 0]] is symmetric, so the gradient is the
    same pair applied to the output gradients, and the backward runs on the
    forward's primitives (autograd would turn the gathers into scatter-adds
    over every edge). ``SelfAdjointPair.apply(pair_fn, x_u, x_i)``."""

    @staticmethod
    def forward(ctx, pair_fn: Callable, x_u: torch.Tensor, x_i: torch.Tensor):
        ctx.pair_fn = pair_fn
        return pair_fn(x_u, x_i)

    @staticmethod
    def backward(ctx, g_u: torch.Tensor, g_i: torch.Tensor):
        return (None, *ctx.pair_fn(g_u, g_i))


def layer_mean(pair, user_emb, item_emb, n_layers: int):
    """K applications of the propagation pair and the layer-stack mean
    (``model/LightGCN/model.py:60-72``), shared by the edge-list layouts
    on one device and on the mesh."""
    eu, ei = user_emb, item_emb
    acc_u, acc_i = eu, ei
    for _ in range(n_layers):
        eu, ei = pair(eu, ei)
        acc_u = acc_u + eu
        acc_i = acc_i + ei
    scale = 1.0 / (n_layers + 1)
    return acc_u * scale, acc_i * scale


class EdgeOrdering(NamedTuple):
    """The same weighted bipartite edge list in both sorted orders (the JAX
    ``EdgeOrdering``): sorted by user, every user's messages are one
    contiguous segment, and likewise by item, so both directions of a layer
    (and, through the self-adjoint backward, both of its gradient) sum
    segments and only gather on the other side."""

    eu_by_u: torch.Tensor  # (E,) edge users, ascending
    ei_by_u: torch.Tensor  # (E,) matching items (user-sorted order)
    norm_by_u: torch.Tensor  # (E,) matching weights
    eu_by_i: torch.Tensor  # (E,) users in item-sorted order
    ei_by_i: torch.Tensor  # (E,) edge items, ascending
    norm_by_i: torch.Tensor  # (E,)


def build_edge_ordering(edge_users: torch.Tensor, edge_items: torch.Tensor,
                        edge_norm: torch.Tensor) -> EdgeOrdering:
    """Sort the weighted edge list by user and by item, stably (equal ids
    keep the input edge order), on the edges' device; once per graph."""
    pu = torch.argsort(edge_users, stable=True)
    pi = torch.argsort(edge_items, stable=True)
    return EdgeOrdering(edge_users[pu], edge_items[pu], edge_norm[pu],
                        edge_users[pi], edge_items[pi], edge_norm[pi])


def _segment_sum(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Row sums of consecutive runs of ``values`` (``lengths[n]`` rows for
    node n, 0 for a node with no edge), each run added in row order."""
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0, unsafe=True)


def sorted_pair(order: EdgeOrdering, n_users: int, n_items: int):
    """The linear pair ``(x_u, x_i) -> (A x_i, A^T x_u)`` over sorted edges,
    no backward of its own: each side gathers the other and sums its
    segments. The segment lengths are counted here, once a pair."""
    len_u = torch.bincount(order.eu_by_u, minlength=n_users)
    len_i = torch.bincount(order.ei_by_i, minlength=n_items)

    def pair_fn(x_u, x_i):
        return (_segment_sum(x_i[order.ei_by_u] * order.norm_by_u[:, None], len_u),
                _segment_sum(x_u[order.eu_by_i] * order.norm_by_i[:, None], len_i))

    return pair_fn


def self_adjoint(pair_fn):
    """``pair_fn`` as a layer with the self-adjoint backward
    (``SelfAdjointPair``)."""

    def pair(x_u, x_i):
        return SelfAdjointPair.apply(pair_fn, x_u, x_i)

    return pair


def make_coo_propagator(order: EdgeOrdering, n_users: int, n_items: int):
    """One bipartite propagation layer over sorted edges, with the
    self-adjoint backward: forward and backward each gather the other side
    and sum segments in a fixed order; nothing scatters."""
    return self_adjoint(sorted_pair(order, n_users, n_items))


def lightgcn_propagate_coo_sorted(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    order: EdgeOrdering,
    n_users: int,
    n_items: int,
    n_layers: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lightgcn_propagate_coo`` on pre-sorted edges: the same math, each
    segment summed in edge order."""
    return layer_mean(make_coo_propagator(order, n_users, n_items), user_emb, item_emb,
                       n_layers)


class BucketedSide(NamedTuple):
    """Degree-bucketed ELL layout of one aggregation direction (the JAX
    ``BucketedSide``): destination nodes grouped by quantized degree
    (``_bucket_caps``), each bucket a padded (Nb, Pb) neighbor matrix and
    weight matrix; aggregation is a gather and a sum over the pad axis, and
    one gather by ``inv`` puts the rows back in node order (zero-degree
    nodes read an appended zeros row)."""

    nbr: tuple  # per bucket: (Nb, Pb) int32 neighbor ids (0-padded)
    w: tuple  # per bucket: (Nb, Pb) edge weights (0-padded), edge_norm's dtype
    inv: torch.Tensor  # (n_out,) int32 row of each node in concat(+zeros)


class BucketedIncidence(NamedTuple):
    users: BucketedSide  # aggregates item vectors INTO users
    items: BucketedSide  # aggregates user vectors INTO items

    def propagate(self, user_emb: torch.Tensor, item_emb: torch.Tensor,
                  n_layers: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """The layer mean over this layout (``lightgcn_propagate_bucketed``)."""
        return lightgcn_propagate_bucketed(user_emb, item_emb, self, n_layers)


def _bucket_caps(deg: np.ndarray, min_cap: int, quantum: int = 8) -> np.ndarray:
    """Per-node ELL row capacity: multiples of ``quantum`` up to 16 quanta,
    then 1/8-octave steps (pad <= 1.125 a row, O(8 log2(max_deg))
    buckets)."""
    deg = deg.astype(np.int64)
    caps = np.maximum(min_cap, -(-deg // quantum) * quantum)
    big = deg > 16 * quantum
    if big.any():
        e = np.floor(np.log2(deg[big])).astype(np.int64)
        step = np.maximum(1, (1 << e) // 8)  # 8 sub-steps per octave
        caps[big] = -(-deg[big] // step) * step
    return caps


class EllGrouping(NamedTuple):
    """One direction's grouping: edges sorted by destination, degrees,
    rowptr, the present nodes and their capacities."""

    nbrs_s: np.ndarray  # neighbor ids, edge order sorted by destination
    w_s: np.ndarray  # edge weights, same order
    deg: np.ndarray  # (n_out,) destination degrees
    rowptr: np.ndarray  # (n_out + 1,) prefix sums of deg
    present: np.ndarray  # destination ids with deg > 0
    caps: np.ndarray  # per-present-node ELL row capacity


def _ell_group(ids, nbrs, w, n_out: int, min_cap: int) -> EllGrouping:
    ids = np.asarray(ids)
    nbrs = np.asarray(nbrs)
    w = np.asarray(w)  # its dtype is kept (f32 from edge_gcn_norm)
    if not np.issubdtype(w.dtype, np.floating):
        w = w.astype(np.float32)
    order = np.argsort(ids, kind="stable")
    ids_s, nbrs_s, w_s = ids[order], nbrs[order], w[order]
    deg = np.bincount(ids_s, minlength=n_out) if ids_s.size else np.zeros(n_out, np.int64)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    present = np.nonzero(deg)[0]
    caps = _bucket_caps(deg[present], min_cap) if present.size else np.zeros(0, np.int64)
    return EllGrouping(nbrs_s, w_s, deg, rowptr, present, caps)


def _ell_fill(g: EllGrouping, sel: np.ndarray, cap: int, w_dtype):
    """(nbr, w) ELL matrices (len(sel), cap) of the selected destinations:
    each row's sorted edge block, zero-padded past its degree."""
    base = g.rowptr[sel]
    pos = base[:, None] + np.arange(cap)[None, :]
    valid = np.arange(cap)[None, :] < g.deg[sel][:, None]
    posc = np.minimum(pos, max(g.nbrs_s.shape[0] - 1, 0))
    nbr_m = np.where(valid, g.nbrs_s[posc], 0).astype(np.int32)
    w_m = np.where(valid, g.w_s[posc], 0.0).astype(w_dtype)
    return nbr_m, w_m


def _bucketize_side(ids, nbrs, w, n_out: int, min_cap: int, device) -> BucketedSide:
    g = _ell_group(ids, nbrs, w, n_out, min_cap)
    nbr_mats, w_mats = [], []
    inv = np.full(n_out, -1, np.int64)
    row_base = 0
    for cap in np.unique(g.caps):
        sel = g.present[g.caps == cap]
        nbr_m, w_m = _ell_fill(g, sel, int(cap), g.w_s.dtype)
        nbr_mats.append(nbr_m)
        w_mats.append(w_m)
        inv[sel] = row_base + np.arange(sel.shape[0])
        row_base += sel.shape[0]
    inv[inv < 0] = row_base  # the appended zeros row

    def put(a):
        return torch.from_numpy(a).to(device)

    return BucketedSide(tuple(map(put, nbr_mats)), tuple(map(put, w_mats)),
                        put(inv.astype(np.int32)))


def build_bucketed_incidence(edge_users, edge_items, edge_norm, n_users: int, n_items: int,
                             min_cap: int = 4, device="cpu") -> BucketedIncidence:
    """Both aggregation directions, built once on the host (numpy, the
    arrays of the JAX function) and placed on ``device``. Padding is at most
    ~1.13x the edges plus ``min_cap`` per low-degree node."""
    return BucketedIncidence(
        users=_bucketize_side(edge_users, edge_items, edge_norm, n_users, min_cap, device),
        items=_bucketize_side(edge_items, edge_users, edge_norm, n_items, min_cap, device),
    )


def _bucketed_aggregate(side: BucketedSide, x: torch.Tensor) -> torch.Tensor:
    D = x.shape[1]
    parts = [(x.index_select(0, nb.reshape(-1)).view(*nb.shape, D)
              * w[:, :, None].to(x.dtype)).sum(dim=1)
             for nb, w in zip(side.nbr, side.w)]
    parts.append(torch.zeros((1, D), dtype=x.dtype, device=x.device))
    return torch.cat(parts).index_select(0, side.inv)


def bucketed_pair(binc: BucketedIncidence):
    """The linear pair ``(x_u, x_i) -> (A x_i, A^T x_u)`` over the bucketed
    layout, no backward of its own."""

    def pair_fn(x_u, x_i):
        return _bucketed_aggregate(binc.users, x_i), _bucketed_aggregate(binc.items, x_u)

    return pair_fn


def make_bucketed_propagator(binc: BucketedIncidence):
    """One bipartite propagation layer over the bucketed layout, with the
    self-adjoint backward: both passes gather and sum, neither scatters."""
    return self_adjoint(bucketed_pair(binc))


def lightgcn_propagate_bucketed(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    binc: BucketedIncidence,
    n_layers: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lightgcn_propagate_coo`` on the bucketed layout: the same math up
    to float summation order."""
    return layer_mean(make_bucketed_propagator(binc), user_emb, item_emb, n_layers)


def edge_gcn_norm(edge_users: torch.Tensor, edge_items: torch.Tensor, n_users: int,
                  n_items: int) -> torch.Tensor:
    """Per-edge symmetric normalization 1/sqrt(d_u d_i), f32, on the edges'
    device: torch-geometric ``gcn_norm(add_self_loops=False)`` weights
    (``model/LightGCN/model.py:53``). Degrees count edge-list entries, so
    pass the DEDUPED edge list (``data/graph.unique_edges``): its degrees are
    the binary ones of the dense ``normalized_bipartite``. Each factor is
    d^-1/2 taken in f64 and rounded to f32 (XLA's f32 rsqrt, which the JAX
    function takes, may sit one f32 step away), their product in f32."""
    return (degree_inv_sqrt(edge_users, n_users)[edge_users]
            * degree_inv_sqrt(edge_items, n_items)[edge_items])

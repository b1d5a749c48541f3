"""The lambda sweep of ``cli/find_lambda``, on one device.

Port of the single-device part of ``lgcnhs_tpu/ops/sweep.py`` (reference
``findLambda.py:83-116``): for every lambda of a grid, F = A . HybridS(l),
the fused scores G * F ranked with seen items excluded (the spread ranker,
ties to the highest index), and the five raw metrics of the list. G, A,
the seen mask, the eval arrays and, on the dense flavor, W_gen and the
Sorensen matrix S are built once outside the loop, as the JAX function
hoists them out of its ``lax.map``.

``lax.map`` becomes a Python loop over the grid on the device: one grid
point's (U, I) and (I, I) temporaries are alive at a time, each point's
metric row stays on the device, and the (L, 5) rows are read on the host
once, at the end. The JAX package leaves the sweep to XLA (no Pallas
kernel), and so does the port: ``torch.matmul`` with TF32 off (F = A . W is
``Precision.HIGHEST`` in JAX), ``torch.sort``, and the metric ops.

Flavors: ``lambda_sweep_metrics`` (dense: W_gen and S hoisted) and
``lambda_sweep_metrics_tall`` (no (I, I) operand: the W-free user-factored
diffusion and the direct Sorensen form). On a mesh
(``lgcnhs_tpu/ops/sweep.py:150-413``): the grid split over every rank with
the operands replicated (``sharded_lambda_sweep``, its tall flavor
``sharded_lambda_sweep_tall``: one grid point a rank is the best use of
the cards at sweep scale), and past the replication budget the catalog
split over the model axis (``item_sharded_lambda_sweep``: W_gen and S
built as collective Grams over the item-sharded A, never whole on one
rank).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

import torch.distributed as dist

from lgcnhs_tpu_torch.ops import metrics_ops
from lgcnhs_tpu_torch.ops.diffusion import (
    general_spreading_matrix, hybrid_resource, user_factored_diffusion_scores,
)
from lgcnhs_tpu_torch.ops.topk import rank_exclude_seen_topk
from lgcnhs_tpu_torch.parallel import sharding
from lgcnhs_tpu_torch.runtime.mesh import MODEL_AXIS, col_sharded

# Column order of the metric rows the sweeps return.
METRIC_COLUMNS = ("P", "R", "NDCG", "H", "I")


def _metrics_for_rec(rec, eval_pos, eval_counts, eval_present, S, n_items,
                     intra_sim: Optional[Callable] = None) -> torch.Tensor:
    """The five raw (unrounded) metrics of one (U, k) list, stacked in
    ``METRIC_COLUMNS`` order. ``intra_sim`` replaces the S-gather form of
    I@k (the tall flavor has no S)."""
    hits = metrics_ops.hit_matrix(rec, eval_pos)
    p, r = metrics_ops.precision_recall_from_hits(hits, eval_counts, eval_present)
    n = metrics_ops.ndcg_from_hits(hits, eval_present)
    h = metrics_ops.hamming_distance(rec, n_items)
    i = (metrics_ops.internal_similarity_from_matrix(rec, S)
         if intra_sim is None else intra_sim(rec))
    return torch.stack([p, r, n, h, i])


def _grid(lambdas, device) -> torch.Tensor:
    """The grid as a tensor on ``device``, its own dtype kept."""
    return torch.as_tensor(lambdas, device=device)


@torch.no_grad()
def lambda_sweep_metrics(
    lambdas,  # (L,) grid; its dtype is the lambda's (f32 from find_lambda)
    G: torch.Tensor,  # (U, I) allocation matrix (masked layer-0 scores)
    A: torch.Tensor,  # (U, I) train+val interaction matrix
    W_gen: torch.Tensor,  # (I, I) general spreading matrix
    seen: torch.Tensor,  # (U, I) bool train+val positives
    eval_pos: torch.Tensor,  # (U, I) bool eval-split positives
    eval_counts: torch.Tensor,  # (U,)
    eval_present: torch.Tensor,  # (U,) bool
    S: torch.Tensor,  # (I, I) Sorensen similarity (metrics_ops.similarity_matrix)
    k: int,
) -> torch.Tensor:
    """(L, 5) raw metrics [P, R, NDCG, H, I] for every lambda, on A's device.

    Per grid point: W = W_gen / (k_i^(1-l) (x) k_j^l), F = A . W
    (``ops/diffusion.hybrid_resource``; ``1 - l`` formed in the grid's dtype,
    as the JAX ``_blended_transfer`` forms it), rec = rank_exclude_seen(G * F):
    the SpreadLightGCNOpti serving semantics (``findLambda.py:95-99``), then
    the metrics on the eval arrays."""
    n_items = A.shape[1]
    rows = []
    for lam in _grid(lambdas, A.device):
        F = hybrid_resource(A, W_gen, lam)
        rec = rank_exclude_seen_topk(G * F, seen, k, filter_seen=True)
        del F
        rows.append(_metrics_for_rec(rec, eval_pos, eval_counts, eval_present, S, n_items))
    return torch.stack(rows)


@torch.no_grad()
def lambda_sweep_metrics_tall(
    lambdas,  # (L,)
    G: torch.Tensor,  # (U, I) allocation matrix
    A: torch.Tensor,  # (U, I) train+val interaction matrix
    seen: torch.Tensor,  # (U, I) bool
    eval_pos: torch.Tensor,  # (U, I) bool
    eval_counts: torch.Tensor,  # (U,)
    eval_present: torch.Tensor,  # (U,) bool
    item_deg: torch.Tensor,  # (I,)
    k: int,
) -> torch.Tensor:
    """``lambda_sweep_metrics`` with no (I, I) operand anywhere, for
    catalogs past ``choose_diffusion``'s dense budget: F from the W-free
    user-factored algebra (``ops/diffusion.user_factored_diffusion_scores``)
    and I@k from the direct co-occurrence form over A itself
    (``metrics_ops.internal_similarity_direct``; the reference's diversity
    metrics read the same train+val matrix, ``findLambda.py:74,106-114``).
    The same rows as the dense flavor up to sum order."""
    n_items = A.shape[1]

    def intra_sim(rec):
        return metrics_ops.internal_similarity_direct(rec, A, item_deg)

    rows = []
    for lam in _grid(lambdas, A.device):
        F = user_factored_diffusion_scores(A, lam)
        rec = rank_exclude_seen_topk(G * F, seen, k, filter_seen=True)
        del F
        rows.append(_metrics_for_rec(rec, eval_pos, eval_counts, eval_present, None, n_items,
                                     intra_sim=intra_sim))
    return torch.stack(rows)


# Per-rank bytes the grid-parallel sweep may spend on replicated operands
# before the item-sharded sweep takes over: two (I, I) operators (W_gen, S)
# and the (U, I)-class arrays, fine at ML-100K/1M scale and past a card's
# memory at catalogs that need a mesh (the JAX package's figure).
SWEEP_REPLICATION_BUDGET_BYTES = 4 * 1024**3


def _replicated_sweep_bytes(n_users: int, n_items: int, itemsize: int = 4) -> int:
    """Per-rank high-water estimate of the grid-parallel sweep: replicated
    operands plus one grid point's (I, I) W and (U, I) F temporaries, at the
    operands' element size (8 under float64)."""
    return itemsize * (3 * n_items * n_items + 6 * n_users * n_items)


def _grid_share(mesh, lambdas):
    """(this rank's slice of the grid, the grid's length): the grid padded
    with its last point to a multiple of the ranks (every rank of the mesh,
    in global rank order: JAX's 1-D ``SWEEP_AXIS`` mesh), the dtype kept."""
    lambdas = torch.as_tensor(np.asarray(lambdas))
    L, n_dev = lambdas.shape[0], mesh.size
    pad = (-L) % n_dev
    if pad:
        lambdas = torch.cat([lambdas, lambdas[-1:].repeat(pad)])
    per = lambdas.shape[0] // n_dev
    pos = int(np.flatnonzero(mesh.devices.reshape(-1) == dist.get_rank())[0])
    return lambdas[pos * per:(pos + 1) * per], L


def _join_grid(rows: torch.Tensor, L: int) -> torch.Tensor:
    """Every rank's (per, 5) rows in rank order, cut to the grid's length."""
    out = rows.new_empty((dist.get_world_size() * rows.shape[0], rows.shape[1]))
    sharding._all_gather(out, rows.contiguous())
    return out[:L]


def _on(mesh, *arrays):
    return [None if a is None else torch.as_tensor(a).to(mesh.device) for a in arrays]


@torch.no_grad()
def sharded_lambda_sweep(
    mesh,
    lambdas,
    G,
    A,
    W_gen,
    seen,
    eval_pos,
    eval_counts,
    eval_present,
    S,
    k: int,
    memory_budget_bytes: int = SWEEP_REPLICATION_BUDGET_BYTES,
    item_deg=None,
) -> torch.Tensor:
    """(L, 5) metrics of the grid on a mesh, in one of two layouts:

    - grid-parallel: the grid split over EVERY rank (the (data, model) axes
      flattened, as JAX's ``SWEEP_AXIS``), the operands replicated, each rank
      running ``lambda_sweep_metrics`` on its points;
    - item-sharded, when replicating would pass ``memory_budget_bytes`` a
      rank: ``item_sharded_lambda_sweep``.

    ``W_gen`` and ``S`` may be None: built here (grid-parallel) or as
    collective Grams (item-sharded). ``item_deg`` is the duplicate-counting
    degree vector of the evaluation (``eval.metrics.EvalContext.item_deg``)
    for S; a column sum of the 0/1 A undercounts duplicated rating rows.
    Both layouts give the same rows. Every rank gets all of them."""
    A_t = torch.as_tensor(A)
    if _replicated_sweep_bytes(A_t.shape[0], A_t.shape[1], A_t.element_size()) \
            > memory_budget_bytes:
        return item_sharded_lambda_sweep(mesh, lambdas, G, A, W_gen, seen, eval_pos,
                                         eval_counts, eval_present, S, k, item_deg=item_deg)
    G, A, W_gen, seen, eval_pos, eval_counts, eval_present, S, item_deg = _on(
        mesh, G, A, W_gen, seen, eval_pos, eval_counts, eval_present, S, item_deg)
    if W_gen is None:
        W_gen = general_spreading_matrix(A)
    if S is None:
        if item_deg is None:
            item_deg = A.float().sum(dim=0)
        S = metrics_ops.similarity_matrix(A.float(), item_deg)
    mine, L = _grid_share(mesh, lambdas)
    rows = lambda_sweep_metrics(mine, G, A, W_gen, seen, eval_pos, eval_counts,
                                eval_present, S, k)
    return _join_grid(rows, L)


@torch.no_grad()
def sharded_lambda_sweep_tall(
    mesh,
    lambdas,
    G,
    A,
    seen,
    eval_pos,
    eval_counts,
    eval_present,
    item_deg,
    k: int,
) -> torch.Tensor:
    """The grid-parallel mesh sweep for tall catalogs: the grid over every
    rank, each point the W-free / S-free flavor (``lambda_sweep_metrics_tall``)
    on replicated (U, I)-class operands, no (I, I) operand on any rank. The
    same rows as the single-device tall sweep."""
    G, A, seen, eval_pos, eval_counts, eval_present, item_deg = _on(
        mesh, G, A, seen, eval_pos, eval_counts, eval_present, item_deg)
    mine, L = _grid_share(mesh, lambdas)
    rows = lambda_sweep_metrics_tall(mine, G, A, seen, eval_pos, eval_counts, eval_present,
                                     item_deg, k)
    return _join_grid(rows, L)


def _sharded_metrics(mesh, rec, eval_blk, eval_counts, eval_present, S_blk, n_items):
    """``_metrics_for_rec`` with the eval positives and S item-sharded: the
    hit matrix and S's pair block read through ``ShardedColumns`` (each
    entry exact on every rank), then the single-device formulas."""
    U, k = rec.shape
    r = rec.long()
    rows = torch.arange(U, device=rec.device)[:, None].expand_as(r)
    hits = sharding.ShardedColumns(mesh, eval_blk)[rows, r].to(torch.float32)
    p, rr = metrics_ops.precision_recall_from_hits(hits, eval_counts, eval_present)
    n = metrics_ops.ndcg_from_hits(hits, eval_present)
    h = metrics_ops.hamming_distance(rec, n_items)
    S_cols = sharding.ShardedColumns(mesh, S_blk)
    pair = S_cols[r[:, :, None], r[:, None, :]]  # (U, k, k)
    diag = S_cols[r, r]
    i = (torch.sum(pair) - torch.sum(diag)) / (float(U) * k * (k - 1))
    return torch.stack([p, rr, n, h, i])


@torch.no_grad()
def item_sharded_lambda_sweep(
    mesh,
    lambdas,
    G,
    A,
    W_gen,
    seen,
    eval_pos,
    eval_counts,
    eval_present,
    S,
    k: int,
    item_deg=None,
) -> torch.Tensor:
    """Catalog-sharded sweep: every (U, I) and (I, I) operand split by item
    columns over the model axis, one grid point at a time. F's column block
    is A . W[:, block], summed over the other ranks' blocks of A in turn;
    ranking is the distributed spread ranker; the metrics read the sharded
    eval arrays. A rank holds O(U I / n + I^2 / n).

    ``W_gen`` and ``S`` may be None: then each rank builds its column block
    as a collective Gram over the item-sharded A (never whole on one rank),
    with the clamps and element types of ``general_spreading_matrix`` and
    ``metrics_ops.similarity_matrix``; S's degrees are ``item_deg`` when
    given. The item axis is padded to the model axis: padded columns have
    A = 0 (degrees unchanged), seen = True and G = -inf (ranked last, never
    emitted), eval_pos = False and S = 0."""
    G, A, seen, eval_pos = (torch.as_tensor(x) for x in (G, A, seen, eval_pos))
    U, I = A.shape
    block = sharding._block_width(mesh, I, k)
    n_model = mesh.shape[MODEL_AXIS]
    I_pad = block * n_model
    start = mesh.index(MODEL_AXIS) * block
    pc = (0, I_pad - I)
    pad = torch.nn.functional.pad
    G_blk = col_sharded(mesh, pad(G, pc, value=-torch.inf))
    A_blk = col_sharded(mesh, pad(A, pc))
    seen_blk = col_sharded(mesh, pad(seen, pc, value=True))
    eval_blk = col_sharded(mesh, pad(eval_pos, pc, value=False))
    eval_counts, eval_present = _on(mesh, eval_counts, eval_present)

    if W_gen is None:
        W_gen_blk = sharding._spreading_block(mesh, A_blk, sharding._user_degrees(mesh, A_blk))
    else:
        W_gen_blk = col_sharded(mesh, pad(torch.as_tensor(W_gen), (0, I_pad - I, 0, I_pad - I)))
    if S is None:
        A32 = A_blk.to(torch.float32)
        if item_deg is None:
            deg = sharding._item_degrees(mesh, A32)
        else:
            deg = pad(torch.as_tensor(item_deg).to(mesh.device, torch.float32), (0, I_pad - I))
        inv = torch.where(deg > 0, torch.rsqrt(deg), torch.zeros_like(deg))
        rows = [A_m.T @ A32 for _, A_m in sharding._ring(mesh, A32)]
        S_blk = torch.cat(rows).mul_(inv[:, None]).mul_(inv[None, start:start + block])
    else:
        S_blk = col_sharded(mesh, pad(torch.as_tensor(S), (0, I_pad - I, 0, I_pad - I)))

    # lambda-invariant: the item degrees, hoisted out of the grid loop
    k_item = sharding._item_degrees(mesh, A_blk)
    padded = torch.arange(start, start + block, device=A_blk.device) >= I
    out = []
    for lam in torch.as_tensor(np.asarray(lambdas)):  # the grid's dtype kept
        denom = sharding._blend_denominator(k_item, k_item[start:start + block], lam,
                                            A_blk.dtype, A_blk.device)
        F_blk = sharding._resource_from_transfer(mesh, A_blk, W_gen_blk / denom)
        fused = (G_blk * F_blk).masked_fill(padded[None, :], -torch.inf)  # -inf * 0 = nan
        rec = sharding._distributed_rank_core(mesh, fused, seen_blk, k, True, block)
        out.append(_sharded_metrics(mesh, rec, eval_blk, eval_counts, eval_present, S_blk, I))
    return torch.stack(out)


def sweep_rows(lambdas, metrics: np.ndarray) -> list:
    """Per-lambda dicts on the host with the reference's 5-decimal rounding
    and F1 of the rounded P and R (``metrics/accurate.py:46-56``), in
    ``eval/metrics.evaluate_recommendations`` key order."""
    rows = []
    for lam, row in zip(np.asarray(lambdas).tolist(), np.asarray(metrics)):
        p, r, n, h, i = (round(float(v), 5) for v in row)
        f1 = 0.0 if p + r == 0 else round(2 * p * r / (p + r), 5)
        rows.append(
            {"lambda": round(float(lam), 4), "P": p, "R": r, "F1": f1,
             "NDCG": n, "H": h, "I": i}
        )
    return rows

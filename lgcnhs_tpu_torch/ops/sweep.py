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
diffusion and the direct Sorensen form). The sharded sweeps
(``sharded_lambda_sweep[_tall]``, ``item_sharded_lambda_sweep``) wait for
the mesh (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from lgcnhs_tpu_torch.ops import metrics_ops
from lgcnhs_tpu_torch.ops.diffusion import hybrid_resource, user_factored_diffusion_scores
from lgcnhs_tpu_torch.ops.topk import rank_exclude_seen_topk

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

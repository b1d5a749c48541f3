"""Host-facing metric suite with reference rounding parity.

Port of ``lgcnhs_tpu/eval/metrics.py``. It aggregates ``ops/metrics_ops``
on the device the caller names and keeps the reference's observable
numerics:

- every metric is rounded to 5 decimals at the stage the reference rounds
  (``metrics/accurate.py:46,56,102``; ``metrics/diversity.py:61-63,115``);
- F1 is the harmonic mean of the ALREADY-ROUNDED P and R
  (``metrics/accurate.py:48-56``), and 0 when P + R = 0;
- P/R/NDCG average only over users present in the eval split
  (``metrics/accurate.py:26``); H and I run over all users
  (``metrics/diversity.py:32,84``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from lgcnhs_tpu_torch.data.graph import (
    EdgeSet,
    interaction_matrix,
    item_degrees,
    pos_bool_matrix,
    user_pos_counts,
    users_present,
)
from lgcnhs_tpu_torch.ops import metrics_ops


@dataclass(frozen=True)
class EvalContext:
    """Eval-side host arrays of one dataset, built once (the reference
    rebuilds them per call, ``main.py:86-94``), and the device the metrics
    run on."""

    n_users: int
    n_items: int
    eval_pos: np.ndarray  # (U, I) bool: eval split positives
    eval_counts: np.ndarray  # (U,)
    eval_present: np.ndarray  # (U,) bool
    interaction: np.ndarray  # (U, I) f32 train+val
    item_deg: np.ndarray  # (I,)
    device: torch.device = torch.device("cpu")

    @classmethod
    def build(
        cls,
        n_users: int,
        n_items: int,
        eval_edges: EdgeSet,
        train_edges: EdgeSet,
        val_edges: EdgeSet,
        device: torch.device | str = "cpu",
    ) -> "EvalContext":
        return cls(
            n_users=n_users,
            n_items=n_items,
            eval_pos=pos_bool_matrix(n_users, n_items, eval_edges),
            eval_counts=user_pos_counts(n_users, eval_edges),
            eval_present=users_present(n_users, eval_edges),
            interaction=interaction_matrix(n_users, n_items, train_edges, val_edges),
            item_deg=item_degrees(n_items, train_edges, val_edges),
            device=torch.device(device),
        )

    def on_device(self, x) -> torch.Tensor:
        """A host array (or a tensor) on the context's device."""
        return torch.as_tensor(x, device=self.device)


def accuracy_unrounded(ctx: EvalContext, rec) -> Tuple[float, float, float]:
    """(P@k, R@k, NDCG@k) before rounding."""
    p, r, n = metrics_ops.all_accuracy_metrics(
        ctx.on_device(rec), ctx.on_device(ctx.eval_pos),
        ctx.on_device(ctx.eval_counts), ctx.on_device(ctx.eval_present),
    )
    return float(p), float(r), float(n)


def diversity_unrounded(ctx: EvalContext, rec) -> Tuple[float, float]:
    """(H@k, I@k) before rounding."""
    rec_t = ctx.on_device(rec)
    h = metrics_ops.hamming_distance(rec_t, ctx.n_items)
    i = metrics_ops.internal_similarity(
        rec_t, ctx.on_device(ctx.interaction), ctx.on_device(ctx.item_deg)
    )
    return float(h), float(i)


def accurate_metrics(ctx: EvalContext, rec) -> Tuple[float, float, float, float]:
    """(P@k, R@k, F1@k, NDCG@k), reference ``getAccurateMetrics``
    (``metrics/accurate.py:104-126``)."""
    p, r, n = accuracy_unrounded(ctx, rec)
    precision = round(p, 5)
    recall = round(r, 5)
    if precision + recall == 0:
        # the reference would ZeroDivisionError here (metrics/accurate.py:55)
        f1 = 0.0
    else:
        f1 = round(2 * precision * recall / (precision + recall), 5)
    return precision, recall, f1, round(n, 5)


def diversity_metrics(ctx: EvalContext, rec) -> Tuple[float, float]:
    """(H@k, I@k), reference ``getDiversityMetrics``
    (``metrics/diversity.py:117-136``)."""
    h, i = diversity_unrounded(ctx, rec)
    return round(h, 5), round(i, 5)


def novelty_metric(ctx: EvalContext, rec) -> float:
    """Average recommended-item degree (``waste/metrics/novelty.py:11-48``)."""
    nov = metrics_ops.novelty_avg_degree(ctx.on_device(rec), ctx.on_device(ctx.item_deg))
    return round(float(nov), 5)


def evaluate_recommendations(ctx: EvalContext, rec, include_novelty: bool = False) -> dict:
    """The six reference metrics as a dict (``main.py:99-106``); Novelty on
    request (the reference prototyped it in ``waste/`` only)."""
    p, r, f1, n = accurate_metrics(ctx, rec)
    h, i = diversity_metrics(ctx, rec)
    out = {"P": p, "R": r, "F1": f1, "NDCG": n, "H": h, "I": i}
    if include_novelty:
        out["Novelty"] = novelty_metric(ctx, rec)
    return out

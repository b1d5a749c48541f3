"""The comparisons that decide ``correct``: each number beside its limit.

Training, against ``reference/train.py`` and ``reference/evaluate.py``
(``TrainReadout``: what the program gave; the reference's, built by the
train driver, has the same form):

- ``loss_gap``, ``grad_gap``, ``change_gap``: each job's start, against
  the reference from the seed: the widest |program - reference| /
  |reference| of epoch 0's loss and of the first interval's last loss;
  over the tables, |program norm - reference norm| of the first gradient,
  over the larger of that table's and the median table's reference norm;
  the same of the tables' change over the first interval (epochs 1 to
  ``epoch_per_eval``), leaving out a table whose reference gradient is
  under a thousandth of the median table's (it moves by Adam's round-off
  alone);
- ``interval_loss_gap``, ``interval_change_gap``: the window's judged
  intervals, each followed by the reference from the program's state at
  its first boundary: the relative gap of its last epoch's loss, and the
  gap of norms of the tables' change over it, as above;
- ``eval_gap``: the evaluation rows at the judged intervals' ends, against
  the reference's evaluation of the program's tables there: the widest
  relative gap over the val loss (over the magnitude of its two terms, as
  the loss crosses zero), P, R, F1, NDCG, H and I.

A readout with nothing to compare reads inf.

Serving (every pass of the window, on a sample of users drawn from the
seed, against ``reference/serve.py``):

- ``score_gap``: the widest gap by which the j-th served item's reference
  score lies below the reference's j-th best, over the best score's
  magnitude; a list with an item out of range, seen or twice reads inf.
"""
from __future__ import annotations

import math
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench.reference.evaluate import ROW

TRAIN_NUMBERS = ("loss_gap", "grad_gap", "change_gap", "interval_loss_gap",
                 "interval_change_gap", "eval_gap")


@dataclass
class StartReadout:
    """A job's start: epoch 0's loss, the first gradient's norms (users,
    items), the first interval's last loss, the tables' change over it."""

    loss0: float
    grad_norms: List[float]
    loss_b: float
    change: List[float]


@dataclass
class SpanReadout:
    """A judged interval: its last loss (None where a job returns), the
    tables' change over it, the evaluation row at its end (or None)."""

    loss: Optional[float]
    change: List[float]
    row: Optional[Dict[str, float]] = None


@dataclass
class TrainReadout:
    starts: List[StartReadout] = field(default_factory=list)
    spans: List[SpanReadout] = field(default_factory=list)


def _rel(a: float, b: float, scale: Optional[float] = None) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b) if scale is None else scale, 1e-30)


def _norm_gap(prog: List[float], ref: List[float], keep) -> float:
    if len(prog) != len(ref) or not all(map(math.isfinite, prog)):
        return math.inf
    base = statistics.median(ref)
    return max((abs(p - r) / max(r, base, 1e-30) for p, r, k in zip(prog, ref, keep) if k),
               default=0.0)


def row_gap(prog: Dict[str, float], ref: Dict[str, float]) -> float:
    return max(_rel(prog[name], ref[name], ref["val_loss_scale"] if name == "val_loss" else None)
               for name in ROW)


def train_numbers(program: TrainReadout, ref_start: StartReadout,
                  ref_spans: List[SpanReadout]) -> Dict[str, float]:
    """The numbers of ``TRAIN_NUMBERS``: ``program``'s starts each against
    ``ref_start`` (every job starts from the same seed), its spans against
    ``ref_spans``, one for one."""
    out = dict.fromkeys(TRAIN_NUMBERS, math.inf)
    med = statistics.median(ref_start.grad_norms)
    moved = [g >= 1e-3 * med for g in ref_start.grad_norms]
    if program.starts:
        out["loss_gap"] = max(max(_rel(s.loss0, ref_start.loss0), _rel(s.loss_b, ref_start.loss_b))
                              for s in program.starts)
        out["grad_gap"] = max(_norm_gap(s.grad_norms, ref_start.grad_norms, [True] * len(moved))
                              for s in program.starts)
        out["change_gap"] = max(_norm_gap(s.change, ref_start.change, moved)
                                for s in program.starts)
    spans = list(zip(program.spans, ref_spans))
    if spans and len(ref_spans) == len(program.spans):
        out["interval_change_gap"] = max(_norm_gap(p.change, r.change, moved) for p, r in spans)
        losses = [(p.loss, r.loss) for p, r in spans if r.loss is not None]
        if losses and all(a is not None for a, _ in losses):
            out["interval_loss_gap"] = max(_rel(a, b) for a, b in losses)
        rows = [row_gap(p.row, r.row) for p, r in spans if r.row is not None and p.row]
        if rows and len(rows) == sum(r.row is not None for _, r in spans):
            out["eval_gap"] = max(rows)
    return out


def score_gap(lists: np.ndarray, scores: torch.Tensor) -> float:
    """``lists`` (S, k) served items of S users; ``scores`` (S, I) the
    reference's, seen items at -inf."""
    S, k = lists.shape
    n_items = scores.shape[1]
    if lists.min(initial=0) < 0 or lists.max(initial=0) >= n_items:
        return math.inf
    if any(np.unique(row).shape[0] != k for row in lists):
        return math.inf
    idx = torch.from_numpy(lists.astype(np.int64)).to(scores.device)
    got = scores.gather(1, idx)
    if not bool(torch.isfinite(got).all()):
        return math.inf
    best = torch.topk(scores, k, dim=1).values
    scale = best[:, 0].abs().clamp_min(1e-30)
    return float(((best - got) / scale[:, None]).max())


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing or nan number fails)."""
    return all(name in numbers and numbers[name] <= limit
               for name, limit in limits.items())

"""SpreadMethod recommenders (ProbS / HeatS / HybridS): no training.

Port of ``lgcnhs_tpu/models/spread.py`` (reference
``model/SpreadMethod/recommend.py``): interaction matrix, W_gen, blended
transfer, two-pass diffusion (``ops/diffusion.diffusion_scores_auto``),
then the spread ranker (``ops/topk.rank_exclude_seen_topk``), on the device
the caller names. No kernel runs here, on the card or off it.

Dataset quirks kept (``model/SpreadMethod/recommend.py:87-105,48-50``):
- ProbS on movielens (and movielens1m): W transposed, lambda 0.01, and the
  seen filter SKIPPED at ranking time;
- HeatS on douban: W transposed, lambda 0.99.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.graph import InteractionGraph, interaction_matrix, pos_bool_matrix
from lgcnhs_tpu_torch.ops.diffusion import diffusion_scores_auto
from lgcnhs_tpu_torch.ops.topk import rank_exclude_seen_topk
from lgcnhs_tpu_torch.runtime.logging import get_logger, stage_timer

SPREAD_METHODS = ("ProbS", "HeatS", "HybridS")


def resolve_spread_variant(method: str, dataset: str, lam: float):
    """(effective lambda, transpose_w, filter_seen) after dataset overrides."""
    if method not in SPREAD_METHODS:
        raise ValueError(f"method must be one of {SPREAD_METHODS}, got {method!r}")
    # ML-1M inherits the movielens quirks: the reference keys them on the
    # config string DATASET == "movielens" (recommend.py:87-105)
    if dataset == "movielens1m":
        dataset = "movielens"
    transpose_w = False
    filter_seen = True
    if method == "ProbS":
        lam = 1.0
        if dataset == "movielens":
            lam, transpose_w, filter_seen = 0.01, True, False
    elif method == "HeatS":
        lam = 0.0
        if dataset == "douban":
            lam, transpose_w = 0.99, True
    return lam, transpose_w, filter_seen


def spread_scores(A: torch.Tensor, method: str, dataset: str, lam: float) -> torch.Tensor:
    """Resource matrix F of a spread method, quirks included, with lambda in
    A's dtype; the algorithm is picked by catalog size
    (``ops.diffusion.choose_diffusion``)."""
    eff_lam, transpose_w, _ = resolve_spread_variant(method, dataset, lam)
    return diffusion_scores_auto(A, torch.as_tensor(eff_lam, dtype=A.dtype),
                                 transpose_w=transpose_w)


def recommend_spread_method(
    graph: InteractionGraph,
    cfg: Config,
    device: torch.device | str,
    method: Optional[str] = None,
) -> np.ndarray:
    """All-user (U, k) int32 recommendations on ``device``, reference
    ``recommendSpreadMethod`` + ``recommendForAllUser``
    (``model/SpreadMethod/recommend.py:18-115``). A is train+val
    (``recommend.py:81``) and so is the seen filter (``recommend.py:31``)."""
    method = method or cfg.model
    log = get_logger()
    with stage_timer(f"{method} diffusion recommendation done", log):
        # bfloat16 compute means f32 here; float64 reproduces the
        # reference's numpy doubles
        dtype = np.float32 if cfg.compute.dtype == "bfloat16" else np.dtype(cfg.compute.dtype)
        A = torch.from_numpy(interaction_matrix(
            graph.n_users, graph.n_items, graph.train, graph.val, dtype=dtype)).to(device)
        _, _, filter_seen = resolve_spread_variant(method, cfg.dataset, cfg.hparams.lambda_)
        F = spread_scores(A, method, cfg.dataset, cfg.hparams.lambda_)
        del A
        seen = torch.from_numpy(
            pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val)).to(device)
        rec = rank_exclude_seen_topk(F, seen, cfg.k, filter_seen=filter_seen)
        return rec.cpu().numpy()

"""LGCNHS fusion models (SpreadLightGCN / SpreadLightGCNOpti).

Port of the single-device ``lgcnhs_tpu/models/fusion.py``. The fusion is
the Hadamard product of

  G -- layer-0 GCN preference scores (``SpreadLightGCN/model.py:55-104``)
  F -- the HybridS diffusion resource A.W over train+val interactions
       (``SpreadLightGCN/model.py:106-120``)

ranked per user with seen items excluded, in two flavors:

- ``recommend_fused`` (``cli/main``): the reference ranker, F_new = G * F
  ranked by ``ops/topk.rank_exclude_seen_topk`` (ties to the highest
  index), plain library ops on any device, as in the JAX package;
- ``serve_fused`` (``cli/retrieve``): the hand-written fused kernel on CUDA
  (``ops/cuda/fusion_serve``), ties to the lowest index.

The mesh flavor (``distributed_fused_recommend``) is not ported (ROADMAP
queue 1 item 7).
"""
from __future__ import annotations

import numpy as np
import torch

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.graph import InteractionGraph, interaction_matrix, pos_bool_matrix
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, layer0_scores
from lgcnhs_tpu_torch.ops.cuda.fusion_serve import fused_lgcnhs_serve, fused_lgcnhs_serve_ref
from lgcnhs_tpu_torch.ops.diffusion import (
    diffusion_scores_auto, general_spreading_matrix, hybrid_resource, hybrid_transfer,
)
from lgcnhs_tpu_torch.ops.topk import MASK_VALUE, rank_exclude_seen_topk
from lgcnhs_tpu_torch.runtime.logging import get_logger, stage_timer


def allocate_matrix(params: LightGCNParams, seen: torch.Tensor) -> torch.Tensor:
    """G: layer-0 preference scores with train+val positives set to -1024
    (``model/SpreadLightGCN/model.py:55-104``)."""
    scores = layer0_scores(params)
    return torch.where(seen, torch.full_like(scores, MASK_VALUE), scores)


def _serve_unfused(ue, ie, A, W, seen, k) -> torch.Tensor:
    """The plain serving chain: G = ue.ie^T at the tables' dtype (f32, or
    f64 for a float64 checkpoint) and F = A.W as an f32 matmul,
    ``where(seen, -3e38, G*F)``, top k lowest index first.

    The JAX package keeps two flavors of this chain (native and HIGHEST
    matmul precision). With TF32 off, an f32 matmul on the card is already
    full f32, so both are this one chain."""
    return fused_lgcnhs_serve_ref(ue, ie, A, W, seen, k)[0]


def serve_route(device_type: str, dtype: torch.dtype, exact: bool) -> str:
    """Which path ``serve_fused`` takes: ``"plain"``, the chain at the
    tables' own dtype, off CUDA, under ``exact`` (``--serve-exact``) and for
    float64 tables (a float64 checkpoint); else ``"kernel"``, the fused
    serving kernel, whose wrapper raises on a dtype other than float32."""
    if device_type == "cuda" and dtype != torch.float64 and not exact:
        return "kernel"
    return "plain"


def serve_fused(
    graph: InteractionGraph,
    cfg: Config,
    params: LightGCNParams,
    exact: bool = False,
) -> np.ndarray:
    """(U, k) int32 recommendations of the fused LGCNHS score, along
    ``serve_route`` (logged on CUDA): the fused kernel on CUDA at any
    catalog size, else the plain chain. ``exact=True`` (CLI
    ``--serve-exact``) is the precision switch: the plain chain on any
    device. Ties go to the lowest index; ``recommend_fused`` is the
    reference ranker beside it."""
    device = params.user_emb.device
    log = get_logger()
    route = serve_route(device.type, params.user_emb.dtype, exact)
    if device.type == "cuda":
        log.info("serve_fused: %s route (%s)", route,
                 str(params.user_emb.dtype).replace("torch.", ""))
    with stage_timer(f"{cfg.model} fused serving done", log):
        A = torch.from_numpy(
            interaction_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
        ).to(device)
        seen = torch.from_numpy(
            pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
        ).to(device)
        W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
        ue, ie = params.user_emb, params.item_emb
        if route == "plain":
            rec = _serve_unfused(ue, ie, A, W, seen, cfg.k)
        else:
            rec = fused_lgcnhs_serve(ue, ie, A, W, seen, cfg.k)[0]
        return rec.cpu().numpy()


def fused_recommend(
    params: LightGCNParams,
    A: torch.Tensor,  # (U, I) f32 train+val interaction matrix
    seen: torch.Tensor,  # (U, I) bool train+val positives
    lam,
    k: int,
) -> torch.Tensor:
    """G -> F -> F_new = G * F -> ranked top-k, (U, k) int32 (reference
    ``SpreadLightGCN/model.py:122-153`` + ``recommend.py:18-75``). F is
    picked by catalog size (``ops.diffusion.choose_diffusion``): the dense
    W_gen chain at parity scales, the W-free factored or blocked algorithm
    past the (I, I) budget. F_new takes the tables' dtype where it is wider
    than A's (f64 tables: f64), as in JAX."""
    G = allocate_matrix(params, seen)
    F = diffusion_scores_auto(A, lam)
    F_new = G * F
    del G, F
    return rank_exclude_seen_topk(F_new, seen, k, filter_seen=True)


def fusion_scores(params: LightGCNParams, A: torch.Tensor, seen: torch.Tensor, lam) -> torch.Tensor:
    """F_new without the ranking, through the dense W_gen chain (the lambda
    sweep reuses G and W_gen; ``cli/find_lambda.py``)."""
    G = allocate_matrix(params, seen)
    return G * hybrid_resource(A, general_spreading_matrix(A), lam)


def recommend_fused(graph: InteractionGraph, cfg: Config, params: LightGCNParams) -> np.ndarray:
    """(U, k) int32 recommendations of SpreadLightGCN[Opti] on the tables'
    device: ``fused_recommend`` with A in f32 and lambda in A's dtype."""
    if tuple(cfg.compute.mesh_shape) != (1, 1):
        raise NotImplementedError(
            "the item-sharded fused recommendation (compute.mesh_shape) is not "
            "ported to lgcnhs_tpu_torch yet (ROADMAP queue 1 item 7)"
        )
    device = params.user_emb.device
    log = get_logger()
    with stage_timer(f"{cfg.model} fused recommendation done", log):
        A = torch.from_numpy(
            interaction_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
        ).to(device)
        seen = torch.from_numpy(
            pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
        ).to(device)
        lam = torch.as_tensor(cfg.hparams.lambda_, dtype=A.dtype)
        return fused_recommend(params, A, seen, lam, cfg.k).cpu().numpy()

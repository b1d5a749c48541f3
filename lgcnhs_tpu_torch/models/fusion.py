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

With a mesh (``compute.mesh_shape``), ``recommend_fused`` ranks through
``distributed_fused_recommend``: G, F and F_new item-sharded, the (I, I)
operator never on one rank, the distributed spread ranker
(``lgcnhs_tpu/models/fusion.py:163-245``).
"""
from __future__ import annotations

import numpy as np
import torch

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.graph import (
    InteractionGraph, dense_positives, edge_array, interaction_matrix, pos_bool_matrix,
)
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, layer0_scores
from lgcnhs_tpu_torch.ops.cuda.fusion_serve import fused_lgcnhs_serve, fused_lgcnhs_serve_ref
from lgcnhs_tpu_torch.ops.cuda.launches import count
from lgcnhs_tpu_torch.ops.diffusion import (
    diffusion_scores_auto, general_spreading_matrix, hybrid_resource, hybrid_transfer,
)
from lgcnhs_tpu_torch.ops.topk import MASK_VALUE, rank_exclude_seen_topk
from lgcnhs_tpu_torch.parallel.sharding import (
    _block_width, _distributed_rank_core, _hybrid_resource_block, _pad_rows,
)
from lgcnhs_tpu_torch.runtime.logging import get_logger, span, stage_timer
from lgcnhs_tpu_torch.runtime.mesh import (
    MODEL_AXIS, col_sharded, mesh_from_config, replicated, row_sharded,
)


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
    reference ranker beside it.

    A and seen are set on the tables' device from the train+val rows
    (``data/graph.dense_positives``); nothing is kept between calls.

    Each call is a ``serve.pass`` span (counted in ``serve_fused.passes``)
    holding a ``serve.build`` of the (2, n) edge array on the host, a
    ``serve.upload`` of it (``serve_fused.h2d_bytes`` adds its 8 n bytes,
    n the train+val rows), a ``serve.build`` of A and seen on the device,
    ``serve.transfer_matrix`` (W), ``serve.rank`` (the launch, or the
    plain chain) and ``serve.download``, which waits for the card
    (``runtime/logging.span``)."""
    device = params.user_emb.device
    log = get_logger()
    count(_COUNTERS, "passes")
    with stage_timer(f"{cfg.model} fused serving done", log, "serve.pass"):
        route = serve_route(device.type, params.user_emb.dtype, exact)
        if device.type == "cuda":
            log.info("serve_fused: %s route (%s)", route,
                     str(params.user_emb.dtype).replace("torch.", ""))
        with span("serve.build"):
            edges = edge_array(graph.train, graph.val)
        edges = _upload(edges, device)
        with span("serve.build"):
            A, seen = dense_positives(graph.n_users, graph.n_items, edges)
            del edges
        with span("serve.transfer_matrix"):
            W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
        ue, ie = params.user_emb, params.item_emb
        with span("serve.rank"):
            if route == "plain":
                rec = _serve_unfused(ue, ie, A, W, seen, cfg.k)
            else:
                rec = fused_lgcnhs_serve(ue, ie, A, W, seen, cfg.k)[0]
        with span("serve.download"):
            return rec.cpu().numpy()


serve_fused.passes = 0  # calls
serve_fused.h2d_bytes = 0  # bytes of the host arrays the calls handed to .to(device)
_COUNTERS = serve_fused  # their owner, also where a caller wraps the module's name


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """``host`` on ``device`` (a copy to the card), its bytes counted."""
    with span("serve.upload"):
        count(_COUNTERS, "h2d_bytes", host.nbytes)
        return torch.from_numpy(host).to(device)


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


def distributed_fused_recommend(
    mesh,
    params: LightGCNParams,
    A,  # (U, I) train+val interaction matrix
    seen,  # (U, I) bool
    lam,
    k: int,
) -> torch.Tensor:
    """Item-block-sharded LGCNHS ranking (SURVEY.md section 2.9): each rank
    holds its item columns of A, seen, G and F_new and its rows of the item
    table; F's column block comes from the other ranks' blocks of A in turn
    (``parallel/sharding._hybrid_resource_block``: no (I, I) operand on any
    rank), and F_new is ranked by the distributed spread ranker. The item
    axis is padded to the model axis with zero-interaction columns (every
    real degree unchanged), seen, with an explicit -inf fused score: ranked
    last, never emitted for k <= I. (U, k) int32 on every rank."""
    A, seen = torch.as_tensor(A), torch.as_tensor(seen)
    n_items = A.shape[1]
    block = _block_width(mesh, n_items, k)
    I_pad = block * mesh.shape[MODEL_AXIS]
    pad = (0, I_pad - n_items)
    A_blk = col_sharded(mesh, torch.nn.functional.pad(A, pad))
    seen_blk = col_sharded(mesh, torch.nn.functional.pad(seen, pad, value=True))
    ue = replicated(mesh, params.user_emb)
    ie_blk = row_sharded(mesh, _pad_rows(torch.as_tensor(params.item_emb), I_pad))
    G_blk = allocate_matrix(LightGCNParams(ue, ie_blk), seen_blk)
    fused = G_blk * _hybrid_resource_block(mesh, A_blk, lam)
    if I_pad != n_items:
        start = mesh.index(MODEL_AXIS) * block
        padded = torch.arange(start, start + block, device=fused.device) >= n_items
        fused = fused.masked_fill(padded[None, :], -torch.inf)
    return _distributed_rank_core(mesh, fused, seen_blk, k, True, block)


def recommend_fused(graph: InteractionGraph, cfg: Config, params: LightGCNParams) -> np.ndarray:
    """(U, k) int32 recommendations of SpreadLightGCN[Opti] on the tables'
    device: ``fused_recommend`` with A in f32 and lambda in A's dtype, or
    ``distributed_fused_recommend`` on the mesh ``compute.mesh_shape``
    resolves to."""
    mesh = mesh_from_config(cfg.compute)
    device = params.user_emb.device
    log = get_logger()
    with stage_timer(f"{cfg.model} fused recommendation done", log):
        A = torch.from_numpy(
            interaction_matrix(graph.n_users, graph.n_items, graph.train, graph.val))
        seen = torch.from_numpy(
            pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val))
        lam = torch.as_tensor(cfg.hparams.lambda_, dtype=A.dtype)
        if mesh is not None:
            rec = distributed_fused_recommend(mesh, params, A, seen, lam, cfg.k)
        else:
            rec = fused_recommend(params, A.to(device), seen.to(device), lam, cfg.k)
        return rec.cpu().numpy()

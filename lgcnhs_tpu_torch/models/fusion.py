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
    positive_parts,
)
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, layer0_scores
from lgcnhs_tpu_torch.ops.cuda.fusion_serve import (
    BLOCK_USERS, W_PARTS, compact_operands, count_k_rows, fused_lgcnhs_serve_ref,
    fused_serve_parts, parts_ld, split_cols_into, split_rows_into,
)
from lgcnhs_tpu_torch.ops.cuda.launches import count
from lgcnhs_tpu_torch.ops.diffusion import (
    diffusion_scores_auto, edge_spreading, general_spreading_matrix, hybrid_resource,
    hybrid_transfer, transfer_block,
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

    Everything is set on the tables' device from the train+val rows, and
    nothing is kept between calls. The kernel route builds the kernel's
    operands themselves (``kernel_operands``): A's bf16 part and seen from
    the edges, W's bf16 parts a block of items at a time, with no (I, I)
    or (U, I) f32 array, and, on the compacted walk (``compact_walk``), A
    restricted to each user block's items. The plain route sets the f32 A
    and seen (``data/graph.dense_positives``) and the dense W.

    Each call is a ``serve.pass`` span (counted in ``serve_fused.passes``)
    holding a ``serve.build`` of the (2, n) edge array on the host, a
    ``serve.upload`` of it (``serve_fused.h2d_bytes`` adds its 8 n bytes,
    n the train+val rows), a ``serve.build`` of A and seen on the device,
    ``serve.transfer_matrix`` (W; on the kernel route one ``serve.w_block``
    a block, counted in ``serve_fused.w_blocks``; on the compacted walk a
    third ``serve.build``, A over each block's items), ``serve.rank`` (the
    launch, or the plain chain) and ``serve.download``, which waits for the
    card (``runtime/logging.span``); after it a compacted launch's
    contraction rows are counted (``fusion_serve.count_k_rows``)."""
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
        ue, ie = params.user_emb, params.item_emb
        if route == "plain":
            with span("serve.build"):
                A, seen = dense_positives(graph.n_users, graph.n_items, edges)
                del edges
            with span("serve.transfer_matrix"):
                W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
            with span("serve.rank"):
                rec = _serve_unfused(ue, ie, A, W, seen, cfg.k)
        else:
            a_parts, w_parts, seen = kernel_operands(graph.n_users, graph.n_items, edges,
                                                     cfg.hparams.lambda_, W_BLOCK)
            del edges
            with span("serve.rank"):
                rec = fused_serve_parts(ue, ie, a_parts, w_parts, seen, cfg.k)[0]
        with span("serve.download"):
            rec = rec.cpu().numpy()
        if route == "kernel":
            count_k_rows(a_parts)
        return rec


serve_fused.passes = 0  # calls
serve_fused.h2d_bytes = 0  # bytes of the host arrays the calls handed to .to(device)
serve_fused.w_blocks = 0  # blocks of W^T's parts built (kernel route)
_COUNTERS = serve_fused  # their owner, also where a caller wraps the module's name

# Items a block of W's parts: ML-1M's catalog is one block, Gowalla's ten;
# a block's (I, b) f32 product stays near 1.5 GB at 91,599 items.
W_BLOCK = 4096
# The compacted walk's bound, a share of the catalog: it is taken where a
# user block's rows, 128 n / U on average (its items are at most its rows),
# are at most this share of I. ML-1M reads 5.2 and is dense; Gowalla 0.097
# and Amazon-Book 0.071 compact.
COMPACT_SHARE = 0.5


def compact_walk(n_users: int, n_items: int, n_rows: int) -> bool:
    """Whether kernel 4 walks each user block's items alone (its
    ``CompactOperands``) rather than the whole catalog, from the shapes of
    its input: U, I and the n train+val rows."""
    return BLOCK_USERS * n_rows <= COMPACT_SHARE * n_users * n_items


def kernel_operands(n_users: int, n_items: int, edges: torch.Tensor, lam,
                    block: int = W_BLOCK):
    """(a, w_parts, seen) for ``fused_serve_parts`` from the (2, n)
    train+val edge array on the device: A's one bf16 part and seen
    (``data/graph.positive_parts``, a ``serve.build``), then, in
    ``serve.transfer_matrix``, W's factors (``ops/diffusion.edge_spreading``)
    and W's three bf16 parts, (3, I, ld), one ``serve.w_block`` per
    ``block`` items j: W[:, j] from A's columns (``transfer_block``, one
    sparse product) split into the parts: rows j of W^T's
    (``split_rows_into``), or on the compacted walk (``compact_walk``)
    columns j of W's own (``split_cols_into``). Live at once: the parts,
    seen and one block's (U, b) and (I, b) f32. ``a`` is A's part, or on the
    compacted walk A's ``CompactOperands`` (a ``serve.build``), made once
    the block's arrays and A's part are freed, so they stay below the
    blocks' peak."""
    ld = parts_ld(n_items)
    compact = compact_walk(n_users, n_items, edges.shape[1])
    with span("serve.build"):
        a_parts, seen = positive_parts(n_users, n_items, ld, edges)
    with span("serve.transfer_matrix"):
        spread = edge_spreading(n_users, n_items, edges, lam)
        w_parts = torch.empty((W_PARTS, n_items, ld), dtype=torch.bfloat16, device=edges.device)
        if compact:
            w_parts[:, :, n_items:] = 0
        for j0 in range(0, n_items, block):
            with span("serve.w_block"):
                count(_COUNTERS, "w_blocks")
                j1 = min(j0 + block, n_items)
                W_cols = transfer_block(spread, a_parts[0, :, j0:j1], j0)
                if compact:
                    split_cols_into(W_cols, w_parts[:, :, j0:j1])
                else:
                    split_rows_into(W_cols, w_parts[:, j0:j1])
                del W_cols
    if not compact:
        return a_parts, w_parts, seen
    del spread, a_parts
    with span("serve.build"):
        return compact_operands(n_users, n_items, edges), w_parts, seen


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

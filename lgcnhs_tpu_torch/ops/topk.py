"""Ranking / top-k retrieval.

Port of the GCN-flavor ranking of ``lgcnhs_tpu/ops/topk.py``: seen user-item
scores are set to exactly -(1 << 10) (the reference's finite sentinel,
``model/LightGCN/evaluation.py:41-52``) and the top k are taken.

Order (``select_topk``, shared by every plain path and kernel twin): value
descending in IEEE total order, so +0.0 ranks above -0.0 as in XLA's
``top_k``, and ties to the lowest index. ``torch.topk`` documents no tie
order, so the plain path is a stable descending sort cut at k.
"""
from __future__ import annotations

from typing import Tuple

import torch

from lgcnhs_tpu_torch.runtime.logging import get_logger

# Exact sentinel the reference writes into excluded entries.
MASK_VALUE = -float(1 << 10)

_KEY_DTYPE = {torch.float32: (torch.int32, 0x7FFFFFFF),
              torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF)}


def select_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the k largest entries of each row of a
    float32/float64 matrix: IEEE total order (+0 above -0), ties to the
    lowest index. Non-NaN inputs."""
    int_dtype, mag = _KEY_DTYPE[x.dtype]
    bits = x.contiguous().view(int_dtype)
    key = bits ^ ((bits >> (bits.element_size() * 8 - 1)) & mag)  # monotone in x
    idx = torch.sort(key, dim=1, descending=True, stable=True)[1][:, :k]
    return torch.gather(x, 1, idx), idx.to(torch.int32)


def masked_topk(scores: torch.Tensor, seen: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k item indices (int32) per user with seen entries masked to -1024."""
    masked = torch.where(seen, torch.full_like(scores, MASK_VALUE), scores)
    return select_topk(masked, k)[1]


def retrieval_route(device_type: str, dtype: torch.dtype) -> str:
    """Which path ``retrieve_topk`` takes: ``"plain"``, the matmul + masked
    top-k chain at the tables' own dtype, off CUDA and for float64 tables (a
    float64 checkpoint), as the JAX ``retrieve_topk`` sends f64 to its
    HIGHEST chain; else ``"kernel"``, the fused retrieval kernel (any
    catalog, any k), whose wrapper raises on a dtype other than float32."""
    if device_type == "cuda" and dtype != torch.float64:
        return "kernel"
    return "plain"


def retrieve_topk(
    user_emb: torch.Tensor, item_emb: torch.Tensor, seen: torch.Tensor, k: int
) -> torch.Tensor:
    """Full-catalog layer-0 retrieval: scores + mask + top-k, (U, k) int32,
    along ``retrieval_route``; the choice is logged on CUDA. The kernel
    raises when it cannot run. Both paths give the same indices on scores
    that are exact in f32."""
    dev = user_emb.device
    route = retrieval_route(dev.type, user_emb.dtype)
    if dev.type == "cuda":
        get_logger().info("retrieve_topk: %s route (I=%d, D=%d, k=%d, %s)", route,
                          *item_emb.shape, k, str(user_emb.dtype).replace("torch.", ""))
    if route == "plain":
        return masked_topk(user_emb @ item_emb.T, seen, k)
    from lgcnhs_tpu_torch.ops.cuda.retrieval import fused_topk_retrieval

    return fused_topk_retrieval(user_emb, item_emb, seen, k)[0]

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


def retrieve_topk(
    user_emb: torch.Tensor, item_emb: torch.Tensor, seen: torch.Tensor, k: int
) -> torch.Tensor:
    """Full-catalog layer-0 retrieval: scores + mask + top-k, (U, k) int32.

    On CUDA this launches the one-shot fused kernel when its score rows fit
    one block's shared memory, else the item-streaming kernel, which takes
    any catalog and any k; either raises when it cannot run. Elsewhere it is
    the plain chain. All paths give the same indices on scores that are
    exact in f32."""
    if user_emb.device.type != "cuda":
        return masked_topk(user_emb @ item_emb.T, seen, k)
    from lgcnhs_tpu_torch.ops.cuda.retrieval import (
        device_smem_limit,
        fits_smem_retrieval,
        fused_topk_retrieval,
        streaming_topk_retrieval,
    )

    log = get_logger()
    n_items, d = item_emb.shape
    if fits_smem_retrieval(n_items, d, device_smem_limit(user_emb.device)):
        log.info("retrieve_topk: one-shot fused kernel (I=%d, D=%d, k=%d)", n_items, d, k)
        return fused_topk_retrieval(user_emb, item_emb, seen, k)[0]
    log.info("retrieve_topk: streaming kernel (I=%d, D=%d, k=%d)", n_items, d, k)
    return streaming_topk_retrieval(user_emb, item_emb, seen, k)[0]

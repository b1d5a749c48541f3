"""Fused retrieval: layer-0 scores + seen mask + top-k in one kernel.

Port of ``lgcnhs_tpu/ops/pallas/retrieval.py`` (``fused_topk_retrieval`` and
``streaming_topk_retrieval``) to hand-written CUDA for Hopper
(``retrieval.cu``, which explains the design and its bound).

Contract, shared by both kernels and their plain twin
``fused_topk_retrieval_ref``: scores ``u . i^T`` in f32; seen entries become
the finite -1024 sentinel (``ops/topk.MASK_VALUE``), so a user whose every
unseen score is below it still gets real (seen) ids; the k best per user in
``ops/topk.select_topk`` order (value descending, +0 above -0, then id
ascending), k distinct ids, ``1 <= k <= I``.
Indices are int32, values f32.

A wrapper given CPU tensors runs the twin; given CUDA tensors it launches
its kernel or raises. ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lgcnhs_tpu_torch.ops.cuda import build
from lgcnhs_tpu_torch.ops.topk import MASK_VALUE, select_topk
ROWS = 8  # users per block, retrieval.cu kRows
MAX_TILE = 4096
MIN_TILE = 128

_LIB = "retrieval"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _check_args(user_emb, item_emb, seen, k) -> None:
    U, D = user_emb.shape
    I, D_i = item_emb.shape
    if D != D_i or tuple(seen.shape) != (U, I):
        raise ValueError(
            f"shape mismatch: user_emb {tuple(user_emb.shape)}, item_emb "
            f"{tuple(item_emb.shape)}, seen {tuple(seen.shape)}"
        )
    if seen.dtype != torch.bool:
        raise TypeError(f"seen must be bool, got {seen.dtype}")
    if not 1 <= k <= I:
        raise ValueError(f"k must be in [1, {I}] (the catalog size), got {k}")


def fused_topk_retrieval_ref(
    user_emb: torch.Tensor, item_emb: torch.Tensor, seen: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of both retrieval kernels: matmul, mask, stable sort."""
    _check_args(user_emb, item_emb, seen, k)
    scores = user_emb @ item_emb.T
    vals, idx = select_topk(torch.where(seen, torch.full_like(scores, MASK_VALUE), scores), k)
    return idx, vals


def _cuda_operands(user_emb, item_emb, seen, k, what):
    _check_args(user_emb, item_emb, seen, k)
    dev = user_emb.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors must be on cpu or cuda, got {dev}")
    for name, t in (("user_emb", user_emb), ("item_emb", item_emb), ("seen", seen)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, user_emb on {dev}")
        if name != "seen" and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    U, I = seen.shape
    return (
        user_emb.contiguous(),
        item_emb.T.contiguous(),  # (D, I): coalesced item reads
        seen.contiguous().view(torch.uint8),
        torch.empty((U, k), dtype=torch.int32, device=dev),
        torch.empty((U, k), dtype=torch.float32, device=dev),
    )


def device_smem_limit(device: torch.device) -> int:
    return build.device_smem_limit(_LIB, device)


def fused_smem_bytes(n_items: int, d: int) -> int:
    """Dynamic shared memory of one one-shot block (retrieval.cu)."""
    return 4 * ROWS * (d + n_items)


def stream_smem_bytes(d: int, k: int, tile: int) -> int:
    """Dynamic shared memory of one streaming block: user rows, tile scores
    and survivor ids, the running (value, id) top-k and the sorted best
    survivors."""
    return 4 * ROWS * (d + 2 * tile + 4 * k)


def fits_smem_retrieval(n_items: int, d: int, smem_limit: int) -> bool:
    """True when the one-shot kernel's score rows fit one block's shared
    memory (``smem_limit``: the device's opt-in limit per block)."""
    return fused_smem_bytes(n_items, d) <= smem_limit


def pick_stream_tile(d: int, k: int, smem_limit: int) -> Optional[int]:
    """Widest power-of-two item tile in [max(MIN_TILE, k), MAX_TILE] whose
    streaming block fits ``smem_limit``, or None when none does. A tile of
    at least k items lets the first tile fill the running top-k; wider tiles
    mean fewer merges."""
    tile = MAX_TILE
    while tile >= max(MIN_TILE, k):
        if stream_smem_bytes(d, k, tile) <= smem_limit:
            return tile
        tile //= 2
    return None


def fused_topk_retrieval(
    user_emb: torch.Tensor, item_emb: torch.Tensor, seen: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (U, k) int32, values (U, k) f32) of the masked preference
    top-k, scores never written to device memory."""
    if user_emb.device.type == "cpu":
        return fused_topk_retrieval_ref(user_emb, item_emb, seen, k)
    u, itT, seen8, idx, vals = _cuda_operands(
        user_emb, item_emb, seen, k, "fused_topk_retrieval"
    )
    (U, D), I = u.shape, itT.shape[1]
    need, limit = fused_smem_bytes(I, D), device_smem_limit(u.device)
    if need > limit:
        raise ValueError(
            f"fused_topk_retrieval: {need} B of shared memory at I={I}, D={D} "
            f"exceeds the block limit {limit} B; use streaming_topk_retrieval"
        )
    lib = build.load_library(_LIB)
    fn = lib.fused_topk_retrieval_launch
    fn.argtypes = [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR]
    fn.restype = _INT
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), itT.data_ptr(), seen8.data_ptr(), U, I, D, k,
                idx.data_ptr(), vals.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "fused_topk_retrieval")
    fused_topk_retrieval.launches += 1
    return idx, vals


fused_topk_retrieval.launches = 0


def streaming_topk_retrieval(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    seen: torch.Tensor,
    k: int,
    item_tile: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_topk_retrieval`` without its catalog cap: item tiles stream
    through a running top-k merge, so shared memory does not grow with I.
    ``item_tile=None`` picks the widest tile that fits (``pick_stream_tile``)."""
    if user_emb.device.type == "cpu":
        return fused_topk_retrieval_ref(user_emb, item_emb, seen, k)
    u, itT, seen8, idx, vals = _cuda_operands(
        user_emb, item_emb, seen, k, "streaming_topk_retrieval"
    )
    (U, D), I = u.shape, itT.shape[1]
    limit = device_smem_limit(u.device)
    if item_tile is None:
        item_tile = pick_stream_tile(D, k, limit)
        if item_tile is None:
            raise ValueError(
                f"streaming_topk_retrieval: no item tile fits {limit} B of "
                f"shared memory at D={D}, k={k}"
            )
    elif item_tile < k or stream_smem_bytes(D, k, item_tile) > limit:
        raise ValueError(f"streaming_topk_retrieval: item_tile {item_tile} must "
                         f"be >= k={k} and fit {limit} B at D={D}")
    lib = build.load_library(_LIB)
    fn = lib.streaming_topk_retrieval_launch
    fn.argtypes = [_PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _PTR, _PTR, _PTR]
    fn.restype = _INT
    with torch.cuda.device(u.device):
        rc = fn(u.data_ptr(), itT.data_ptr(), seen8.data_ptr(), U, I, D, k,
                item_tile, idx.data_ptr(), vals.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "streaming_topk_retrieval")
    streaming_topk_retrieval.launches += 1
    return idx, vals


streaming_topk_retrieval.launches = 0

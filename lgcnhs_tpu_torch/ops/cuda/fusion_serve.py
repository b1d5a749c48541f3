"""Fused LGCNHS serving: G = u.i^T, F = A.W, G*F with seen items excluded,
and top-k in one kernel.

Port of ``lgcnhs_tpu/ops/pallas/fusion_serve.fused_lgcnhs_serve`` to
hand-written CUDA for Hopper (``fusion_serve.cu``, which explains the design
and its bound).

Contract, shared by the kernel and its plain twin ``fused_lgcnhs_serve_ref``
(which is the serving chain ``models/fusion._serve_unfused`` runs): G and F
in f32, the fused score ``where(seen, -3e38, G * F)``, and the k best per
user in ``ops/topk.select_topk`` order (value descending, +0 above -0, then
id ascending; a user with no interactions scores +-0 everywhere) with k
distinct ids,
``1 <= k <= I``. A user with fewer than k unseen items gets its seen items,
lowest id first, at -3e38 in the tail. Indices are int32, values f32.

The wrapper given CPU tensors runs the twin; given CUDA tensors it launches
the kernel or raises. ``fused_lgcnhs_serve.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lgcnhs_tpu_torch.ops.cuda import build
from lgcnhs_tpu_torch.ops.topk import select_topk

EXCLUDED = -3.0e38
ROWS = 4  # users per block, fusion_serve.cu kRows

_LIB = "fusion_serve"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int


def _check_args(user_emb, item_emb, A, W, seen, k) -> None:
    U, D = user_emb.shape
    I = item_emb.shape[0]
    if (item_emb.shape[1] != D or tuple(A.shape) != (U, I)
            or tuple(W.shape) != (I, I) or tuple(seen.shape) != (U, I)):
        raise ValueError(
            f"shape mismatch: user_emb {tuple(user_emb.shape)}, item_emb "
            f"{tuple(item_emb.shape)}, A {tuple(A.shape)}, W {tuple(W.shape)}, "
            f"seen {tuple(seen.shape)}"
        )
    if seen.dtype != torch.bool:
        raise TypeError(f"seen must be bool, got {seen.dtype}")
    if not 1 <= k <= I:
        raise ValueError(f"k must be in [1, {I}] (the catalog size), got {k}")


def fused_lgcnhs_serve_ref(user_emb, item_emb, A, W, seen, k) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin: two matmuls, the exclusion, a stable sort."""
    _check_args(user_emb, item_emb, A, W, seen, k)
    fused = (user_emb @ item_emb.T) * (A @ W)
    vals, idx = select_topk(torch.where(seen, torch.full_like(fused, EXCLUDED), fused), k)
    return idx, vals


def smem_bytes(n_items: int, d: int) -> int:
    """Dynamic shared memory of one block (fusion_serve.cu): user rows and
    fused rows."""
    return 4 * ROWS * (d + n_items)


def fits_smem_serve(n_items: int, d: int, smem_limit: int) -> bool:
    """True when one block's fused rows fit ``smem_limit`` (the device's
    opt-in shared-memory limit per block)."""
    return smem_bytes(n_items, d) <= smem_limit


def device_smem_limit(device: torch.device) -> int:
    return build.device_smem_limit(_LIB, device)


def fused_lgcnhs_serve(
    user_emb: torch.Tensor,  # (U, D) layer-0 user table
    item_emb: torch.Tensor,  # (I, D) layer-0 item table
    A: torch.Tensor,  # (U, I) train+val interaction matrix
    W: torch.Tensor,  # (I, I) HybridS transfer matrix
    seen: torch.Tensor,  # (U, I) bool
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (U, k) int32, values (U, k) f32) of the top-k fused scores,
    no (U, I) intermediate written to device memory."""
    if user_emb.device.type == "cpu":
        return fused_lgcnhs_serve_ref(user_emb, item_emb, A, W, seen, k)
    _check_args(user_emb, item_emb, A, W, seen, k)
    dev = user_emb.device
    if dev.type != "cuda":
        raise ValueError(f"fused_lgcnhs_serve: tensors must be on cpu or cuda, got {dev}")
    operands = {"user_emb": user_emb, "item_emb": item_emb, "A": A, "W": W}
    for name, t in (*operands.items(), ("seen", seen)):
        if t.device != dev:
            raise ValueError(f"fused_lgcnhs_serve: {name} is on {t.device}, user_emb on {dev}")
        if name != "seen" and t.dtype != torch.float32:
            raise TypeError(f"fused_lgcnhs_serve: {name} must be float32, got {t.dtype}")
    U, D = user_emb.shape
    I = item_emb.shape[0]
    need, limit = smem_bytes(I, D), device_smem_limit(dev)
    if need > limit:
        raise ValueError(
            f"fused_lgcnhs_serve: {need} B of shared memory at I={I}, D={D} "
            f"exceeds the block limit {limit} B; serve with --serve-exact"
        )
    u = user_emb.contiguous()
    itT = item_emb.T.contiguous()
    W_c = W.contiguous()
    seen8 = seen.contiguous().view(torch.uint8)
    # A as CSR, columns ascending within a row (the kernel skips A's zeros)
    rows, cols = A.nonzero(as_tuple=True)
    a_val = A[rows, cols].contiguous()
    a_col = cols.to(torch.int32)
    a_ptr = torch.zeros(U + 1, dtype=torch.int32, device=dev)
    a_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=U), 0)
    idx = torch.empty((U, k), dtype=torch.int32, device=dev)
    vals = torch.empty((U, k), dtype=torch.float32, device=dev)

    lib = build.load_library(_LIB)
    fn = lib.fused_lgcnhs_serve_launch
    fn.argtypes = [_PTR] * 7 + [_INT] * 4 + [_PTR] * 3
    fn.restype = _INT
    with torch.cuda.device(dev):
        rc = fn(u.data_ptr(), itT.data_ptr(), a_ptr.data_ptr(), a_col.data_ptr(),
                a_val.data_ptr(), W_c.data_ptr(), seen8.data_ptr(), U, I, D, k,
                idx.data_ptr(), vals.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "fused_lgcnhs_serve")
    fused_lgcnhs_serve.launches += 1
    return idx, vals


fused_lgcnhs_serve.launches = 0

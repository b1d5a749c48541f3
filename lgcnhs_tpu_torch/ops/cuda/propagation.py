"""Dual propagation product (R @ X, R^T @ Y) and the LightGCN propagations
built on it.

Port of ``lgcnhs_tpu/ops/pallas/propagation.py`` to hand-written CUDA for
Hopper (``propagation.cu``, which explains the design and its bound).

Contract of ``dual_matmul(R, X, Y, RT=None)``, shared by the kernel and
its plain twin ``dual_matmul_ref``: R (U, I) is float32, bfloat16 or int8; X (I, D) and
Y (U, D) share one dtype, float32 or bfloat16; a float R has that dtype too
(mixed float dtypes raise, as the JAX kernel does). Outputs are float32,
every product formed and summed in f32. The backward is the same product on
the cotangents, cast to the compute dtype first:
``(dY, dX) = dual(R, gI, gU)``, returned in that dtype (``_dual_bwd``).
The kernel also reads R's transpose ``RT`` (``transpose_for_dual``):
``dual_matmul`` builds it when not given, and a caller that reuses R passes
it instead (the trainer builds it once per run, as its incidence is
constant, and hands it to ``lightgcn_propagate_dual_binary``).

The wrappers given CPU tensors run the twin; given CUDA tensors they launch
the kernel or raise. ``dual_matmul.launches`` counts kernel launches,
forward and backward.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import torch

from lgcnhs_tpu_torch.ops.cuda import build

MAX_D = 128  # propagation.cu: a lane owns d = lane + 32 m, m < 4
WARPS, CAP = 8, 512  # propagation.cu kWarps, kCap: each warp's (column, value) buffer

_LIB = "propagation"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.int8, torch.bfloat16), (torch.int8, torch.float32))


def _check_args(R, X, Y) -> None:
    if R.dim() != 2 or X.dim() != 2 or Y.dim() != 2:
        raise ValueError("dual_matmul takes 2-d R, X, Y")
    U, I = R.shape
    if X.shape[0] != I or Y.shape[0] != U or X.shape[1] != Y.shape[1]:
        raise ValueError(
            f"shape mismatch: R {tuple(R.shape)}, X {tuple(X.shape)}, Y {tuple(Y.shape)}"
        )
    if X.dtype != Y.dtype or (R.dtype.is_floating_point and R.dtype != X.dtype) \
            or (R.dtype, X.dtype) not in PAIRS:
        raise ValueError(
            f"dual_matmul operand dtypes must agree (got R={R.dtype}, X={X.dtype}, "
            f"Y={Y.dtype}); cast consistently before calling"
        )


def _dual_plain(R, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin's arithmetic: R in the compute dtype (exact for 0/1), then
    f32 matmuls (TF32 off on the card) of the f32-widened operands."""
    _check_args(R, X, Y)
    Rf = R.to(X.dtype).float()
    return Rf @ X.float(), Rf.T @ Y.float()


def smem_bytes(d: int) -> int:
    """Static shared memory of one block at width ``d`` (propagation.cu):
    each warp's buffer of (int32 column, f32 value) entries and its f32
    partial row of ``32 * ceil(d / 32)`` (rounded to 1, 2 or 4 lanes'
    worth); 36,864 B at d = 128, as ptxas reports."""
    per_lane = 1 if d <= 32 else 2 if d <= 64 else 4
    return 8 * WARPS * CAP + 4 * WARPS * 32 * per_lane


def fits_smem_dual(d: int, smem_limit: int) -> bool:
    """True when the kernel takes width ``d`` (a lane owns ``d / 32``
    accumulators, at most 4) and its blocks fit ``smem_limit`` (the
    device's shared memory per block). The memory is static and under the
    48 KB a block has without opting in, so on sm_90 the width decides.
    Its only other scratch is R's transpose, one more copy of R."""
    return 1 <= d <= MAX_D and smem_bytes(d) <= smem_limit


def device_smem_limit(device: torch.device) -> int:
    return build.device_smem_limit(_LIB, device)


def fits_dual(d: int, device: torch.device) -> bool:
    """The dispatch guard: the kernel's ``fits_smem_dual`` on a CUDA device;
    the twin on the CPU takes any width."""
    if device.type != "cuda":
        return True
    return fits_smem_dual(d, device_smem_limit(device))


def transpose_for_dual(R: torch.Tensor) -> torch.Tensor:
    """R^T as the contiguous (I, U) copy the kernel scans for R^T @ Y.
    Build it once per propagation call and pass it to every ``dual_matmul``
    of that call (``RT``); the backward reuses it."""
    return R.t().contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernel's vector
    loads), copied only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _dual_kernel(R, X, Y, RT) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_args(R, X, Y)
    dev = R.device
    if dev.type != "cuda":
        raise ValueError(f"dual_matmul: the kernel takes cuda tensors, got {dev}")
    for name, t in (("X", X), ("Y", Y), ("RT", RT)):
        if t.device != dev:
            raise ValueError(f"dual_matmul: {name} is on {t.device}, R on {dev}")
    U, I = R.shape
    D = X.shape[1]
    if tuple(RT.shape) != (I, U) or RT.dtype != R.dtype:
        raise ValueError(f"dual_matmul: RT must be R transposed, got {tuple(RT.shape)} "
                         f"{RT.dtype} for R {tuple(R.shape)} {R.dtype}")
    limit = device_smem_limit(dev)
    if not fits_smem_dual(D, limit):
        raise ValueError(
            f"dual_matmul: width D={D} is above {MAX_D} or {smem_bytes(D)} B of shared "
            f"memory exceed the block limit {limit} B; use ops/propagation"
        )
    out_u = torch.empty((U, D), dtype=torch.float32, device=dev)
    out_i = torch.empty((I, D), dtype=torch.float32, device=dev)
    if U == 0 or I == 0:
        return out_u.zero_(), out_i.zero_()
    R_c, RT_c = _aligned(R), _aligned(RT)
    X_c, Y_c = X.contiguous(), Y.contiguous()

    lib = build.load_library(_LIB)
    fn = lib.dual_matmul_launch
    fn.argtypes = [_INT, _INT] + [_PTR] * 4 + [_INT] * 3 + [_PTR] * 3
    fn.restype = _INT
    with torch.cuda.device(dev):
        rc = fn(_CODES[R.dtype], _CODES[X.dtype], R_c.data_ptr(), RT_c.data_ptr(),
                X_c.data_ptr(), Y_c.data_ptr(), U, I, D, out_u.data_ptr(),
                out_i.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "dual_matmul")
    dual_matmul.launches += 1
    return out_u, out_i


def _dual_on_device(R, X, Y, RT):
    """The kernel for CUDA tensors, the twin only for CPU tensors."""
    return _dual_plain(R, X, Y) if R.device.type == "cpu" else _dual_kernel(R, X, Y, RT)


def _dual_twin(R, X, Y, RT):
    return _dual_plain(R, X, Y)


class _Dual(torch.autograd.Function):
    """(R @ X, R^T @ Y) with the JAX kernel's custom VJP (``_dual_bwd``):
    cotangents cast to the compute dtype, the same product swapped, the
    gradients returned in the compute dtype; R gets none."""

    @staticmethod
    def forward(ctx, R, X, Y, RT, impl: Callable):
        ctx.save_for_backward(R, RT)
        ctx.cdt = X.dtype
        ctx.impl = impl
        return impl(R, X, Y, RT)

    @staticmethod
    def backward(ctx, g_u, g_i):
        R, RT = ctx.saved_tensors
        d_y, d_x = ctx.impl(R, g_i.to(ctx.cdt).contiguous(), g_u.to(ctx.cdt).contiguous(), RT)
        return None, d_x.to(ctx.cdt), d_y.to(ctx.cdt), None, None


def dual_matmul_ref(R, X, Y, RT=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin (same contract and backward), on any device; ``RT``
    is accepted for the kernel's signature and not read."""
    return _Dual.apply(R, X, Y, RT, _dual_twin)


def dual_matmul(R, X, Y, RT=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R @ X, R^T @ Y) as f32: the CUDA kernel, forward and backward, for
    CUDA tensors; the twin for CPU tensors. ``RT``, R's transpose from
    ``transpose_for_dual``, is built here when not given."""
    if RT is None and R.device.type == "cuda":
        RT = transpose_for_dual(R)
    return _Dual.apply(R, X, Y, RT, _dual_on_device)


dual_matmul.launches = 0


def lightgcn_propagate_dual(
    user_emb: torch.Tensor,  # (U, D)
    item_emb: torch.Tensor,  # (I, D)
    R_hat: torch.Tensor,  # (U, I)
    n_layers: int = 3,
    bf16_matmul: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``lightgcn_propagate_pallas``
    (``lgcnhs_tpu/ops/pallas/propagation.py:198``): the layer mean of K
    sym-normalized propagation steps (``model/LightGCN/model.py:60-72``),
    each step one ``dual_matmul``. With ``bf16_matmul`` R_hat and each
    layer's inputs are cast to bf16; sums and the mean stay f32. On CUDA
    each step builds R_hat's transpose (the trainer takes the binary
    route, which takes a prebuilt one)."""
    Rl = R_hat.to(torch.bfloat16) if bf16_matmul else R_hat
    cast = (lambda a: a.to(torch.bfloat16)) if bf16_matmul else (lambda a: a)
    eu, ei = user_emb, item_emb
    acc_u, acc_i = eu, ei
    for _ in range(n_layers):
        eu, ei = dual_matmul(Rl, cast(ei), cast(eu))
        acc_u = acc_u + eu
        acc_i = acc_i + ei
    scale = 1.0 / (n_layers + 1)
    return acc_u * scale, acc_i * scale


def lightgcn_propagate_dual_binary(
    user_emb: torch.Tensor,  # (U, D)
    item_emb: torch.Tensor,  # (I, D)
    R8: torch.Tensor,  # (U, I) int8 BINARY interaction matrix
    du_inv: torch.Tensor,  # (U,) 1/sqrt(user degree), 0 for isolated users
    di_inv: torch.Tensor,  # (I,) 1/sqrt(item degree)
    n_layers: int = 3,
    bf16_matmul: bool = False,
    RT: Optional[torch.Tensor] = None,  # R8's transpose (transpose_for_dual)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``lightgcn_propagate_pallas_binary``
    (``lgcnhs_tpu/ops/pallas/propagation.py:235``): R_hat factored as
    diag(du_inv) R diag(di_inv) with R strictly 0/1, so the streamed operand
    is int8 with exact values and the degree scales apply to the embeddings:

        e_u' = du_inv * (R  @ (di_inv * e_i))
        e_i' = di_inv * (R^T @ (du_inv * e_u))

    with the ``dual_matmul`` operands cast to bf16 under ``bf16_matmul``.
    Without ``RT``, each step on CUDA builds R8's transpose."""
    cdt = torch.bfloat16 if bf16_matmul else torch.float32
    Rp = R8.to(torch.int8)
    du = du_inv[:, None].float()
    di = di_inv[:, None].float()
    eu, ei = user_emb, item_emb
    acc_u, acc_i = eu, ei
    for _ in range(n_layers):
        ou, oi = dual_matmul(Rp, (di * ei).to(cdt), (du * eu).to(cdt), RT)
        eu = du * ou
        ei = di * oi
        acc_u = acc_u + eu
        acc_i = acc_i + ei
    scale = 1.0 / (n_layers + 1)
    return acc_u * scale, acc_i * scale

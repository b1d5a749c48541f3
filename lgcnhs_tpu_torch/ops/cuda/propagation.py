"""Dual propagation product (R @ X, R^T @ Y) and the LightGCN propagations
built on it.

Port of ``lgcnhs_tpu/ops/pallas/propagation.py`` to hand-written CUDA for
Hopper (``propagation.cu``, which explains the design and its bound).

Contract of ``dual_matmul(R, X, Y)``, shared by the kernel and its plain
twin ``dual_matmul_ref``: R (U, I) is float32, bfloat16 or int8; X (I, D) and
Y (U, D) share one dtype, float32 or bfloat16; a float R has that dtype too
(mixed float dtypes raise, as the JAX kernel does). Outputs are float32,
every product formed and summed in f32. The backward is the same product on
the cotangents, cast to the compute dtype first:
``(dY, dX) = dual(R, gI, gU)``, returned in that dtype (``_dual_bwd``).
The kernel reads R's rows in 16-byte copies, so R needs 16-byte aligned
rows: ``pad_for_dual`` makes a copy whose row stride is padded with zero
columns to a multiple of 64 and returns its (U, I) view. ``dual_matmul``
pads R itself when its rows are not aligned; a caller that reuses R pads it
once instead (the trainer, once per run, as its incidence is constant).

The wrappers given CPU tensors run the twin; given CUDA tensors they launch
the kernel or raise. ``dual_matmul.launches`` counts the calls that
launched the kernel, forward and backward; ``dual_matmul.reduce_launches``
those that also launched its second kernel, the fixed-order sum of the
split-K parts.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Tuple

import torch

from lgcnhs_tpu_torch.ops.cuda import build

MAX_D = 128  # propagation.cu: output tiles up to 128 columns
CHUNK = 64  # propagation.cu kTile: the depth (items or users) of one chunk
ROW_ALIGN = 64  # pad_for_dual's row stride, a multiple of 64 entries

_LIB = "propagation"
_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
         (torch.int8, torch.bfloat16), (torch.int8, torch.float32))
_PADDED = "_dual_rows_padded"  # set on pad_for_dual's views


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


def smem_bytes(d: int, r_dtype: torch.dtype = torch.int8,
               e_dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory of one block at width ``d`` (propagation.cu
    ``Layout``, for the CPU tests; on the card the dispatch reads the
    launcher's ``dual_matmul_smem_bytes``, and ``chip_smoke.py`` holds the
    two equal): 4 chunks in the copy ring, each the raw R tile (BM x 64 or
    64 x BM entries, rows padded by 16 bytes, except role I's int8 rows
    with bf16 X/Y, which are swizzled) and 64 rows of X or Y, DT entries
    wide (d rounded up to 16, 32, 64 or 128; + 8 for f32). BM, a block's
    output rows, is 128 for the bf16 pairs up to DT = 64, else 64.
    73,728 B at d = 64 for int8/bf16, the training pair."""
    dt = 16 if d <= 16 else 32 if d <= 32 else 64 if d <= 64 else 128
    mma, size = e_dtype == torch.bfloat16, r_dtype.itemsize
    bm, v = (128 if mma and dt <= 64 else 64), 16 // size
    raw = max(bm * (CHUNK + v), CHUNK * (bm + (0 if mma and size == 1 else v))) * size
    rows = CHUNK * (dt + (0 if mma else 8)) * e_dtype.itemsize
    return 4 * (raw + rows)


def dual_splits(n_users: int, n_items: int, bm: int, slots: int) -> Tuple[int, int]:
    """(su, si): how many parts the kernel splits role U's depth (the
    items) and role I's (the users) into, for blocks of ``bm`` output rows
    (``dual_matmul_block_rows``) of which ``slots`` are resident on the
    card at once (SMs times ``dual_matmul_resident_blocks``). The fewest
    chunks per part such that every block is resident at once, so that the
    work is spread evenly over the card; both roles get parts of about that
    many chunks. (1, 1) when there are enough tiles without splitting."""
    nk_u, nk_i = -(-n_items // CHUNK), -(-n_users // CHUNK)
    tiles_u, tiles_i = -(-n_users // bm), -(-n_items // bm)
    per = max(1, -(-(tiles_u * nk_u + tiles_i * nk_i) // slots))
    while per < max(nk_u, nk_i):
        su, si = -(-nk_u // per), -(-nk_i // per)
        if tiles_u * su + tiles_i * si <= slots:
            return max(su, 1), max(si, 1)
        per += 1
    return 1, 1


def fits_smem_dual(d: int, smem_limit: int) -> bool:
    """True when the kernel takes width ``d`` (1 <= d <= 128) and the
    blocks of every dtype pair fit ``smem_limit`` (the device's opt-in
    shared memory per block) by ``smem_bytes``; the widest, f32/f32 at
    d = 128, needs 208,896 B, at d = 64 143,360 B."""
    return 1 <= d <= MAX_D and all(smem_bytes(d, r, e) <= smem_limit for r, e in PAIRS)


def device_smem_limit(device: torch.device) -> int:
    return build.device_smem_limit(_LIB, device)


def fits_dual(d: int, device: torch.device) -> bool:
    """The dispatch guard: on a CUDA device, the kernel takes width ``d``
    and its blocks fit the device's shared memory for every dtype pair, by
    the launcher's own figures; the twin on the CPU takes any width."""
    if device.type != "cuda":
        return True
    return 1 <= d <= MAX_D and all(_smem_fits(device, _CODES[r], _CODES[e], d)
                                   for r, e in PAIRS)


def pad_for_dual(R: torch.Tensor) -> torch.Tensor:
    """R's padded-stride copy: a zeroed (U, ld) buffer, ld = I rounded up
    to a multiple of ``ROW_ALIGN``, holding R in its first I columns.
    Returns the (U, I) view, equal to R, whose rows are 16-byte aligned
    for the kernel's copies; the kernel never uses the columns past I.
    Build it once per R and pass it to every ``dual_matmul`` on R (the
    view is marked, so the kernel takes it without checking it again)."""
    U, I = R.shape
    ld = max(ROW_ALIGN, -(-I // ROW_ALIGN) * ROW_ALIGN)
    buf = torch.zeros((U, ld), dtype=R.dtype, device=R.device)
    buf[:, :I] = R
    view = buf[:, :I]
    setattr(view, _PADDED, True)
    return view


def rows_aligned(R: torch.Tensor) -> bool:
    """True when the kernel can read R as it lies: unit column stride, a
    16-byte aligned start and row stride, and every row readable up to
    column I rounded up to 16 bytes."""
    U, I = R.shape
    es, ld = R.element_size(), R.stride(0)
    need = -(-I * es // 16) * 16
    if R.stride(1) != 1 or R.data_ptr() % 16 or (ld * es) % 16 or ld * es < need:
        return False
    return (R.storage_offset() + (U - 1) * ld) * es + need <= R.untyped_storage().nbytes()


def _kernel_ready(R: torch.Tensor) -> torch.Tensor:
    """R itself where the kernel can read it (or the twin will run), else
    its padded copy."""
    if R.device.type != "cuda" or getattr(R, _PADDED, False) or rows_aligned(R):
        return R
    return pad_for_dual(R)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous with a 16-byte aligned start (the kernel's copies),
    copied only when it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


@functools.lru_cache(maxsize=None)
def _library():
    """The propagation library, its launcher's C types bound once."""
    lib = build.load_library(_LIB)
    lib.dual_matmul_launch.argtypes = [_INT, _INT, _PTR, _INT, _PTR, _PTR] + [_INT] * 6 \
        + [_PTR] * 4
    lib.dual_matmul_launch.restype = _INT
    return lib


@functools.lru_cache(maxsize=None)
def _smem_fits(dev: torch.device, r_code: int, e_code: int, d: int) -> bool:
    smem = _library().dual_matmul_smem_bytes(r_code, e_code, d)
    return 0 < smem <= device_smem_limit(dev)


@functools.lru_cache(maxsize=None)
def _plan(dev: torch.device, U: int, I: int, D: int, r_code: int, e_code: int):
    """(su, si, workspace floats) of a launch at this shape and dtype pair:
    the splits (``dual_splits``) from the launcher's block rows and the
    blocks of its kernel resident on the whole card. Raises when the width
    is not taken or the blocks do not fit the device."""
    if not 1 <= D <= MAX_D or not _smem_fits(dev, r_code, e_code, D):
        raise ValueError(
            f"dual_matmul: width D={D} is outside [1, {MAX_D}] or its blocks' shared "
            f"memory exceeds the block limit {device_smem_limit(dev)} B; use ops/propagation"
        )
    lib = _library()
    with torch.cuda.device(dev):
        per_sm = lib.dual_matmul_resident_blocks(r_code, e_code, D)
    if per_sm < 1:
        raise RuntimeError(f"dual_matmul: no block of width {D} fits an SM of {dev}")
    slots = per_sm * torch.cuda.get_device_properties(dev).multi_processor_count
    su, si = dual_splits(U, I, lib.dual_matmul_block_rows(r_code, e_code, D), slots)
    return su, si, ((su if su > 1 else 0) * U + (si if si > 1 else 0) * I) * D


_WORKSPACES: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _workspace(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """A buffer of at least ``n`` floats for the split-K partials, one per
    (device, stream), grown as needed: launches on one stream run in order,
    so each launch may reuse what the one before it used."""
    ws = _WORKSPACES.get((dev, stream))
    if ws is None or ws.numel() < n:
        ws = _WORKSPACES[(dev, stream)] = torch.empty(n, dtype=torch.float32, device=dev)
    return ws


def _dual_kernel(R, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch. R comes through ``_kernel_ready``: rows the kernel can
    read as they lie."""
    _check_args(R, X, Y)
    dev = R.device
    if dev.type != "cuda":
        raise ValueError(f"dual_matmul: the kernel takes cuda tensors, got {dev}")
    for name, t in (("X", X), ("Y", Y)):
        if t.device != dev:
            raise ValueError(f"dual_matmul: {name} is on {t.device}, R on {dev}")
    U, I = R.shape
    D = X.shape[1]
    r_code, e_code = _CODES[R.dtype], _CODES[X.dtype]
    su, si, n_ws = _plan(dev, U, I, D, r_code, e_code)
    out_u = torch.empty((U, D), dtype=torch.float32, device=dev)
    out_i = torch.empty((I, D), dtype=torch.float32, device=dev)
    if U == 0 or I == 0:
        return out_u.zero_(), out_i.zero_()
    # X and Y rows of lde entries, a whole number of 16-byte copies
    per_copy = 16 // X.element_size()
    lde = -(-D // per_copy) * per_copy
    X_c, Y_c = (_aligned(t if lde == D else torch.nn.functional.pad(t, (0, lde - D)))
                for t in (X, Y))
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream, n_ws).data_ptr() if n_ws else None
    lib = _library()
    with torch.cuda.device(dev):
        rc = lib.dual_matmul_launch(
            r_code, e_code, R.data_ptr(), R.stride(0), X_c.data_ptr(), Y_c.data_ptr(), lde,
            U, I, D, su, si, ws, out_u.data_ptr(), out_i.data_ptr(), stream)
    build.check_launch(lib, rc, "dual_matmul")
    dual_matmul.launches += 1
    if n_ws:
        dual_matmul.reduce_launches += 1
    return out_u, out_i


def _dual_on_device(R, X, Y):
    """The kernel for CUDA tensors, the twin only for CPU tensors."""
    return _dual_plain(R, X, Y) if R.device.type == "cpu" else _dual_kernel(R, X, Y)


class _Dual(torch.autograd.Function):
    """(R @ X, R^T @ Y) with the JAX kernel's custom VJP (``_dual_bwd``):
    cotangents cast to the compute dtype, the same product swapped, the
    gradients returned in the compute dtype; R gets none."""

    @staticmethod
    def forward(ctx, R, X, Y, impl: Callable):
        ctx.save_for_backward(R)
        ctx.cdt = X.dtype
        ctx.impl = impl
        return impl(R, X, Y)

    @staticmethod
    def backward(ctx, g_u, g_i):
        (R,) = ctx.saved_tensors
        d_y, d_x = ctx.impl(R, g_i.to(ctx.cdt).contiguous(), g_u.to(ctx.cdt).contiguous())
        return None, d_x.to(ctx.cdt), d_y.to(ctx.cdt), None


def dual_matmul_ref(R, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin (same contract and backward), on any device."""
    return _Dual.apply(R, X, Y, _dual_plain)


def dual_matmul(R, X, Y) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R @ X, R^T @ Y) as f32: the CUDA kernel, forward and backward, for
    CUDA tensors; the twin for CPU tensors. A CUDA R whose rows the kernel
    cannot read as they lie is padded here (``pad_for_dual``)."""
    return _Dual.apply(_kernel_ready(R), X, Y, _dual_on_device)


dual_matmul.launches = 0
dual_matmul.reduce_launches = 0


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
    R_hat's rows are padded once for all layers (``pad_for_dual``) where
    the kernel needs it."""
    Rl = _kernel_ready(R_hat.to(torch.bfloat16) if bf16_matmul else R_hat)
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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Counterpart of ``lightgcn_propagate_pallas_binary``
    (``lgcnhs_tpu/ops/pallas/propagation.py:235``): R_hat factored as
    diag(du_inv) R diag(di_inv) with R strictly 0/1, so the streamed operand
    is int8 with exact values and the degree scales apply to the embeddings:

        e_u' = du_inv * (R  @ (di_inv * e_i))
        e_i' = di_inv * (R^T @ (du_inv * e_u))

    with the ``dual_matmul`` operands cast to bf16 under ``bf16_matmul``.
    A CUDA R8 is padded once for all layers where the kernel needs it (the
    trainer passes it padded: ``pad_for_dual``)."""
    cdt = torch.bfloat16 if bf16_matmul else torch.float32
    Rp = _kernel_ready(R8.to(torch.int8))
    du = du_inv[:, None].float()
    di = di_inv[:, None].float()
    eu, ei = user_emb, item_emb
    acc_u, acc_i = eu, ei
    for _ in range(n_layers):
        ou, oi = dual_matmul(Rp, (di * ei).to(cdt), (du * eu).to(cdt))
        eu = du * ou
        ei = di * oi
        acc_u = acc_u + eu
        acc_i = acc_i + ei
    scale = 1.0 / (n_layers + 1)
    return acc_u * scale, acc_i * scale

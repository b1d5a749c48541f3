"""Fused LGCNHS serving: G = u.i^T, F = A.W, G*F with seen items excluded,
and top-k in one kernel, at any catalog size.

Port of ``lgcnhs_tpu/ops/pallas/fusion_serve.fused_lgcnhs_serve`` to
hand-written CUDA for Hopper (``fusion_serve.cu``, which explains the design
and its bound: F on the tensor cores from exact bf16 parts of A and W, G in
f32, a running top-k per user).

Contract, shared by the kernel and its plain twin ``fused_lgcnhs_serve_ref``
(which is the serving chain ``models/fusion._serve_unfused`` runs): G and F
in f32, the fused score ``where(seen, -3e38, G * F)``, and the k best per
user in ``ops/topk.select_topk`` order (value descending, +0 above -0, then
id ascending; a user with no interactions scores +-0 everywhere) with k
distinct ids,
``1 <= k <= I``. A user with fewer than k unseen items gets its seen items,
lowest id first, at -3e38 in the tail. Indices are int32, values f32; A and
W any finite f32.

The wrapper given CPU tensors runs the twin; given CUDA tensors it launches
the kernel or raises. ``fused_lgcnhs_serve.launches`` counts the calls that
launched the kernel, ``fused_lgcnhs_serve.merge_launches`` those that also
launched its second kernel, the merge of the catalog parts, and
``fused_lgcnhs_serve.split_launches`` the launches of the kernel that splits
A and W into bf16 parts (two a call, three when A is not exact in bf16);
a launch captured into a CUDA graph counts at each replay
(``ops/cuda/launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from lgcnhs_tpu_torch.ops.cuda import build
from lgcnhs_tpu_torch.ops.cuda.launches import count_launch
from lgcnhs_tpu_torch.ops.cuda.retrieval import _padded_t, _sm_count, spread_parts
from lgcnhs_tpu_torch.ops.topk import select_topk

EXCLUDED = -3.0e38
BLOCK_USERS = 128  # users a block, fusion_serve.cu kBM
BLOCK_ITEMS = 128  # items a tile, kBN
CHUNK = 32  # contraction depth of one staged chunk, kKC
STAGES = 4  # chunks in the copy ring, kStages
W_PARTS = 3  # bf16 parts of W, kWP
G_SLICE = 16  # depth of one staged slice of the G operands, kGD
WARPS = 8

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


def bf16_parts(x: torch.Tensor, n: int, ld: int) -> torch.Tensor:
    """x (rows, cols) f32 as n bf16 parts, (n, rows, ld), columns past cols
    zero. With n = 3 the parts are x's significand 8 bits at a time
    (truncation: the top 16 bits of the f32, then of the remainder, then the
    remainder), so their sum is x exactly for normal floats; n = 1 is x
    rounded to bf16, exact only where x is. Made in row blocks, so the f32
    temporaries stay near 256 MB whatever x's size."""
    rows, cols = x.shape
    out = torch.zeros((n, rows, ld), dtype=torch.bfloat16, device=x.device)
    step = max(1, (1 << 26) // max(cols, 1))
    for r0 in range(0, rows, step):
        rest = x[r0:r0 + step].float().contiguous()
        for p in range(n - 1):
            part = (rest.view(torch.int32) & -65536).view(torch.float32)
            out[p, r0:r0 + step, :cols] = part  # exact: 8 significand bits
            rest = rest - part  # exact: the bits below them
        out[n - 1, r0:r0 + step, :cols] = rest
    return out


class ServeOperands(NamedTuple):
    """The kernel's operands: the transposed tables (rows padded to 4
    floats) and the bf16 parts of A and W (rows padded to 64 entries)."""
    uT: torch.Tensor  # (D, ldu) f32
    itT: torch.Tensor  # (D, ldi) f32
    a_parts: torch.Tensor  # (1 or 3, U, ldk) bf16
    w_parts: torch.Tensor  # (3, I, ldw) bf16, parts of W^T


def serve_operands(user_emb, item_emb, A, W) -> ServeOperands:
    """Splits A and W once per call: W^T always in three parts (both
    operands of the product K-major); A in one when every entry is exact in
    bf16 (the 0/1 interaction matrix of the serving path), else in three.
    On the card the split is the one-pass ``bf16_parts_kernel``
    (``fused_lgcnhs_serve.split_launches`` counts its launches), which
    flags an A that one part does not hold; one int is read back, and only
    such an A is split again. Else ``bf16_parts``."""
    I = W.shape[0]
    ld = I + (-I % 64)  # rows start on 128-byte lines, so no 64-byte chunk straddles two
    if A.device.type == "cpu":
        a_exact = bool((A.to(torch.bfloat16).float() == A).all())
        a_parts = bf16_parts(A, 1 if a_exact else 3, ld)
        w_parts = bf16_parts(W.T, W_PARTS, ld)
    else:
        w_parts = split_on_card(W, W_PARTS, ld, transpose=True)
        inexact = torch.zeros(1, dtype=torch.int32, device=A.device)
        a_parts = split_on_card(A, 1, ld, inexact=inexact)
        if inexact.item():
            a_parts = split_on_card(A, 3, ld)
    return ServeOperands(_padded_t(user_emb), _padded_t(item_emb), a_parts, w_parts)


def split_on_card(x: torch.Tensor, n: int, ld: int, transpose: bool = False,
                  inexact: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bf16_parts(x.T if transpose else x, n, ld)`` by the library's
    kernel, in one pass over x. With n = 1 and ``inexact`` (one int32 on
    the card, zero), the kernel sets it to 1 where an entry is not exact
    in bf16."""
    rows, cols = x.shape
    x = x.contiguous()
    out = torch.empty((n, cols if transpose else rows, ld), dtype=torch.bfloat16,
                      device=x.device)
    lib, _ = _launcher()
    with torch.cuda.device(x.device):
        rc = lib.bf16_parts_launch(x.data_ptr(), rows, cols, ld, n, int(transpose),
                                   out.data_ptr(), None if inexact is None else inexact.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "bf16_parts")
    count_launch(fused_lgcnhs_serve, "split_launches")
    return out


def serve_block_bytes(k: int, a_parts: int, smem_limit: int) -> Tuple[int, int]:
    """(shared memory, workspace bytes) of one block of the kernel
    (``fusion_serve.cu`` ``ServeSmem``, whose ``fused_serve_smem_bytes`` and
    ``fused_serve_workspace_bytes`` give the same): the copy ring (four
    chunks of 32 deep: ``a_parts`` A parts of 128 users and three W parts of
    128 items, bf16), which the epilogue reuses for the 128 x 136 f32 fused
    tile and two 16-deep G slices; three ints a user; per warp a tile's
    survivors (128 keys and ids) and a fold's ranked survivors (min(128,
    k)); then the long lists, per user the running top-k and per warp a
    fold's merged list (k keys and ids each), in shared memory as far as
    they fit ``smem_limit`` and in the workspace past that. Neither this
    nor the launcher's sizing takes the catalog size or the embedding
    width: the kernel streams both."""
    ring = STAGES * 2 * CHUNK * (a_parts * BLOCK_USERS + W_PARTS * BLOCK_ITEMS)
    epilogue = 4 * (BLOCK_USERS * (BLOCK_ITEMS + 8) + G_SLICE * (BLOCK_USERS + BLOCK_ITEMS))
    near = max(ring, epilogue) + 4 * (3 * BLOCK_USERS + WARPS * 2 * BLOCK_ITEMS
                                      + WARPS * 2 * min(BLOCK_ITEMS, k))
    lists = (BLOCK_USERS + WARPS) * 2 * k  # ints
    for shared in (lists, WARPS * 2 * k, 0):  # all, the merge lists, none
        if near + 4 * shared <= smem_limit:
            return near + 4 * shared, 4 * (lists - shared)
    raise ValueError(f"fused_lgcnhs_serve: a block needs {near} B of shared memory, "
                     f"the device allows {smem_limit} B")


class ServePlan(NamedTuple):
    parts: int  # catalog parts
    part_len: int  # items a part (whole 128-item tiles)
    smem_limit: int
    ws_bytes: int  # workspace bytes a block


def serve_plan(lib: ctypes.CDLL, U: int, I: int, k: int, a_parts: int, dev: torch.device) -> ServePlan:
    """How the kernel splits the catalog: from its own occupancy (blocks an
    SM holds at this k) and the SM count, the fewest parts whose blocks
    fill the card's block slots evenly (``spread_parts``)."""
    limit = build.device_smem_limit(_LIB, dev)
    per_block = lib.fused_serve_workspace_bytes(k, a_parts, limit)
    resident = _resident_blocks(lib, k, a_parts, limit, dev)
    if per_block < 0 or resident < 1:
        raise RuntimeError(f"fused_lgcnhs_serve: no block fits at k={k} within {limit} B "
                           "of shared memory")
    parts, part_len = spread_parts(-(-U // BLOCK_USERS), -(-I // BLOCK_ITEMS), BLOCK_ITEMS,
                                   _sm_count(dev) * resident)
    return ServePlan(parts, part_len, limit, per_block)


@functools.lru_cache(maxsize=None)
def _resident_blocks(lib, k, a_parts, limit, dev) -> int:
    with torch.cuda.device(dev):
        return lib.fused_serve_resident_blocks(k, a_parts, limit)


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
    ops = serve_operands(user_emb, item_emb, A, W)
    lib, fn = _launcher()
    idx, vals, parts = launch_kernel(lib, fn, ops, seen, k)
    count_launch(fused_lgcnhs_serve)
    if parts > 1:
        count_launch(fused_lgcnhs_serve, "merge_launches")
    return idx, vals


def launch_kernel(lib: ctypes.CDLL, fn, ops: ServeOperands, seen: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One launch of the kernel of ``lib`` (``fn``: its launcher, typed by
    ``bind``) on prepared operands: (indices, values, catalog parts); with
    more than one part the launcher also ran the merge."""
    D, U = ops.uT.shape[0], seen.shape[0]
    I = ops.w_parts.shape[1]
    dev = seen.device
    plan = serve_plan(lib, U, I, k, ops.a_parts.shape[0], dev)
    seen8 = seen.contiguous().view(torch.uint8)
    idx = torch.empty((U, k), dtype=torch.int32, device=dev)
    vals = torch.empty((U, k), dtype=torch.float32, device=dev)
    n_part = plan.parts * U * k if plan.parts > 1 else 0
    part_idx = torch.empty(n_part, dtype=torch.int32, device=dev)
    part_val = torch.empty(n_part, dtype=torch.float32, device=dev)
    ws = None
    if plan.ws_bytes:  # the long lists that do not fit shared memory
        blocks = -(-U // BLOCK_USERS) * plan.parts
        ws = torch.empty(blocks * plan.ws_bytes // 4, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(ops.uT.data_ptr(), ops.uT.shape[1], ops.itT.data_ptr(), ops.itT.shape[1],
                ops.a_parts.data_ptr(), ops.a_parts.shape[0], ops.a_parts.shape[2],
                ops.w_parts.data_ptr(), ops.w_parts.shape[2], seen8.data_ptr(),
                U, I, D, k, plan.parts, plan.part_len, plan.smem_limit,
                None if ws is None else ws.data_ptr(), part_idx.data_ptr(),
                part_val.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "fused_lgcnhs_serve")
    return idx, vals, plan.parts


fused_lgcnhs_serve.launches = 0
fused_lgcnhs_serve.merge_launches = 0
fused_lgcnhs_serve.split_launches = 0


def bind(lib: ctypes.CDLL):
    """Sets the C types of a library of ``fusion_serve.cu``; its launcher."""
    for name in ("fused_serve_smem_bytes", "fused_serve_workspace_bytes"):
        getattr(lib, name).argtypes = [_INT] * 3
        getattr(lib, name).restype = ctypes.c_longlong
    lib.fused_serve_resident_blocks.argtypes = [_INT] * 3
    lib.fused_serve_resident_blocks.restype = _INT
    lib.bf16_parts_launch.argtypes = [_PTR] + [_INT] * 5 + [_PTR] * 3
    lib.bf16_parts_launch.restype = _INT
    fn = lib.fused_lgcnhs_serve_launch
    fn.argtypes = ([_PTR, _INT, _PTR, _INT, _PTR, _INT, _INT, _PTR, _INT, _PTR]
                   + [_INT] * 7 + [_PTR] * 6)
    fn.restype = _INT
    return fn


@functools.lru_cache(maxsize=None)
def _launcher():
    """(library, launcher) of the kernel, its C types bound once."""
    lib = build.load_library(_LIB)
    return lib, bind(lib)

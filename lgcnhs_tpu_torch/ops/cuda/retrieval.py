"""Fused retrieval: layer-0 scores + seen mask + top-k in one kernel.

Port of ``lgcnhs_tpu/ops/pallas/retrieval.py`` to hand-written CUDA for
Hopper (``retrieval.cu``, which explains the design and its bound): one
kernel takes the place of both Pallas kernels, ``fused_topk_retrieval`` and
``streaming_topk_retrieval``, at every catalog size and every k.

Contract, shared by the kernel and its plain twin
``fused_topk_retrieval_ref``: scores ``u . i^T`` in f32; seen entries become
the finite -1024 sentinel (``ops/topk.MASK_VALUE``), so a user whose every
unseen score is below it still gets real (seen) ids; the k best per user in
``ops/topk.select_topk`` order (value descending, +0 above -0, then id
ascending), k distinct ids, ``1 <= k <= I``.
Indices are int32, values f32.

The wrapper given CPU tensors runs the twin; given CUDA tensors it
launches the kernel or raises. ``fused_topk_retrieval.launches`` counts the
calls that launched the kernel; ``.merge_launches`` those that also
launched its second kernel, the merge of the catalog parts; a launch
captured into a CUDA graph counts at each replay (``ops/cuda/launches``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from lgcnhs_tpu_torch.ops.cuda import build
from lgcnhs_tpu_torch.ops.cuda.launches import count_launch
from lgcnhs_tpu_torch.ops.topk import MASK_VALUE, select_topk

TOPK_USERS = 48  # users a block, retrieval.cu kTU
STEP = 128  # items a block scores per step, kStep
SLICE = 16  # depth of one staged operand slice, kDC
TOPK_SLICES = 2  # staged slices in flight, kTSlices
TOPK_BUFFER = 48  # survivors a user buffers between merges, kBuf
WARPS = 8  # warps a block, every kernel (common.cuh kWarps)

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
    """The plain twin of the retrieval kernel: matmul, mask, stable sort."""
    _check_args(user_emb, item_emb, seen, k)
    scores = user_emb @ item_emb.T
    vals, idx = select_topk(torch.where(seen, torch.full_like(scores, MASK_VALUE), scores), k)
    return idx, vals


def _check_cuda(user_emb, item_emb, seen, k, what) -> torch.device:
    _check_args(user_emb, item_emb, seen, k)
    dev = user_emb.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: tensors must be on cpu or cuda, got {dev}")
    for name, t in (("user_emb", user_emb), ("item_emb", item_emb), ("seen", seen)):
        if t.device != dev:
            raise ValueError(f"{what}: {name} is on {t.device}, user_emb on {dev}")
        if name != "seen" and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    return dev


def _outputs(U, k, dev):
    return (torch.empty((U, k), dtype=torch.int32, device=dev),
            torch.empty((U, k), dtype=torch.float32, device=dev))


def device_smem_limit(device: torch.device) -> int:
    return build.device_smem_limit(_LIB, device)


def topk_block_bytes(k: int, smem_limit: int) -> Tuple[int, int]:
    """(shared memory, workspace bytes) of one block
    (``retrieval.cu`` ``TopkSmem``, whose ``fused_topk_smem_bytes`` and
    ``fused_topk_workspace_bytes`` give the same): two staged slices of 16
    x (48 users + 128 items) floats; four ints a user; per user a buffer of
    48 survivors (keys and ids); per warp the ranked survivors of a merge
    (min(128, k)); then the long lists, per user the running top-k and per
    warp a merge list (k keys and ids each), in shared memory as far as
    they fit ``smem_limit`` and in the workspace past that. Neither the
    catalog size nor the embedding width enters: the kernel streams both."""
    near = 4 * (TOPK_SLICES * SLICE * (TOPK_USERS + STEP) + 4 * TOPK_USERS
                + TOPK_USERS * 2 * TOPK_BUFFER + WARPS * 2 * min(STEP, k))
    lists = (TOPK_USERS + WARPS) * 2 * k  # ints
    for shared in (lists, WARPS * 2 * k, 0):  # all, the merge lists, none
        if near + 4 * shared <= smem_limit:
            return near + 4 * shared, 4 * (lists - shared)
    raise ValueError(f"fused_topk_retrieval: a block needs {near} B of shared memory, "
                     f"the device allows {smem_limit} B")


TOPK_MIN_PART_STEPS = 32  # steps a part keeps before parts may spread over waves


def topk_plan(n_users: int, n_items: int, resident: int, n_sms: int) -> Tuple[int, int]:
    """(parts, part_len): how the kernel splits the catalog into parts of
    whole 128-item steps over the card's ``n_sms`` x ``resident`` block
    slots. Each part starts its users' lists afresh, sorting while
    most scores survive, and later waves start from the k-th entries that
    finished parts shared. So: the ``spread_parts`` split (blocks fill the
    slots evenly over waves) while its parts keep at least 32 steps each,
    else as many parts as the user groups of 48 fit into one wave, at
    least one. On an H100 (``tools/kernel_ab.py``, k=100, device ms,
    merges included): at ML-1M (29 steps) 2 parts 0.549, 4 parts 0.594
    (with blocks of 64 users 2 parts 0.69, 8 parts 0.92); at 49,410 items
    (387 steps) 2 parts 3.58, 6 parts 3.67."""
    groups, steps = -(-n_users // TOPK_USERS), -(-n_items // STEP)
    parts, part_len = spread_parts(groups, steps, STEP, n_sms * resident)
    if part_len >= TOPK_MIN_PART_STEPS * STEP:
        return parts, part_len
    parts = max(1, min(steps, n_sms * resident // groups))
    per = -(-steps // parts)
    return -(-steps // per), per * STEP


def spread_parts(groups: int, steps: int, step_len: int, slots: int) -> Tuple[int, int]:
    """(parts, part_len): a catalog of ``steps`` steps of ``step_len`` items
    split into parts, each part a block for each of ``groups`` user groups.
    The fewest parts (at most 32) whose blocks fill ``slots`` at least 90%
    evenly (blocks / (slots x the waves they take)), or the most even, then
    rounded to whole steps per part."""
    best = (0.0, 1)
    for parts in range(1, min(32, steps) + 1):
        blocks = groups * parts
        even = blocks / (-(-blocks // slots) * slots)
        if even > best[0] + 1e-9:
            best = (even, parts)
        if even >= 0.9:
            break
    per = -(-steps // best[1])
    return -(-steps // per), per * step_len


def fused_topk_retrieval(
    user_emb: torch.Tensor, item_emb: torch.Tensor, seen: torch.Tensor, k: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (U, k) int32, values (U, k) f32) of the masked preference
    top-k, scores never written to device memory: blocks of 48 users walk
    their part of the catalog in 128-item steps with a running top-k, each
    user's best k-th entry so far shared between the parts
    (``retrieval.cu``); the parts' lists are then merged."""
    if user_emb.device.type == "cpu":
        return fused_topk_retrieval_ref(user_emb, item_emb, seen, k)
    dev = _check_cuda(user_emb, item_emb, seen, k, "fused_topk_retrieval")
    (U, D), I = user_emb.shape, item_emb.shape[0]
    lib, fn = _topk_launcher()
    limit = device_smem_limit(dev)
    per_block = lib.fused_topk_workspace_bytes(k, limit)
    resident = _topk_resident_blocks(lib, k, limit, dev)
    if per_block < 0 or resident < 1:
        raise RuntimeError(f"fused_topk_retrieval: no block fits at k={k} within {limit} B "
                           "of shared memory")
    parts, part_len = topk_plan(U, I, resident, _sm_count(dev))
    uT, itT = _padded_t(user_emb), _padded_t(item_emb)
    seen8 = seen.contiguous().view(torch.uint8)
    idx, vals = _outputs(U, k, dev)
    n_part = parts * U * k if parts > 1 else 0
    part_idx = torch.empty(n_part, dtype=torch.int32, device=dev)
    part_val = torch.empty(n_part, dtype=torch.float32, device=dev)
    ws = None
    if per_block:  # the long lists that do not fit shared memory
        blocks = -(-U // TOPK_USERS) * parts
        ws = torch.empty(blocks * per_block // 4, dtype=torch.int32, device=dev)
    bound = torch.empty(U, dtype=torch.int64, device=dev)  # the launcher clears it
    with torch.cuda.device(dev):
        rc = fn(uT.data_ptr(), uT.shape[1], itT.data_ptr(), itT.shape[1], seen8.data_ptr(),
                U, I, D, k, parts, part_len, limit, None if ws is None else ws.data_ptr(),
                bound.data_ptr(), part_idx.data_ptr(), part_val.data_ptr(), idx.data_ptr(),
                vals.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "fused_topk_retrieval")
    count_launch(fused_topk_retrieval)
    if parts > 1:
        count_launch(fused_topk_retrieval, "merge_launches")
    return idx, vals


fused_topk_retrieval.launches = 0
fused_topk_retrieval.merge_launches = 0


def bind_topk(lib: ctypes.CDLL):
    """Sets the C types of the kernel's functions in a library of
    ``retrieval.cu``; its launcher."""
    for name in ("fused_topk_smem_bytes", "fused_topk_workspace_bytes"):
        getattr(lib, name).argtypes = [_INT, _INT]
        getattr(lib, name).restype = ctypes.c_longlong
    lib.fused_topk_resident_blocks.argtypes = [_INT, _INT]
    lib.fused_topk_resident_blocks.restype = _INT
    fn = lib.fused_topk_retrieval_launch
    fn.argtypes = [_PTR, _INT, _PTR, _INT, _PTR] + [_INT] * 7 + [_PTR] * 7
    fn.restype = _INT
    return fn


@functools.lru_cache(maxsize=None)
def _topk_launcher():
    """(library, launcher) of the kernel, its C types bound once."""
    lib = build.load_library(_LIB)
    return lib, bind_topk(lib)


@functools.lru_cache(maxsize=None)
def _topk_resident_blocks(lib, k, limit, dev) -> int:
    with torch.cuda.device(dev):
        return lib.fused_topk_resident_blocks(k, limit)


def _padded_t(t: torch.Tensor) -> torch.Tensor:
    """t (n, D) as its (D, n) transpose with rows padded by zeros to a
    multiple of 4 floats (16-byte copies)."""
    n = t.shape[0]
    return torch.nn.functional.pad(t.T, (0, -n % 4)).contiguous()


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count

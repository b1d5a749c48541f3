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
its kernel or raises. ``<wrapper>.launches`` counts the calls that launched
the wrapper's kernel; ``streaming_topk_retrieval.merge_launches`` those
that also launched its second kernel, the merge of the catalog parts.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from lgcnhs_tpu_torch.ops.cuda import build
from lgcnhs_tpu_torch.ops.topk import MASK_VALUE, select_topk
ROWS = 8  # users per one-shot block, retrieval.cu kRows
STREAM_USERS = 32  # users per streaming block, retrieval.cu kSU
STREAM_STEP = 128  # items a streaming block scores per step, retrieval.cu kStep
STREAM_SLICE = 16  # depth of one staged operand slice, retrieval.cu kDC
STREAM_SLICES = 3  # staged slices in flight, retrieval.cu kSlices
STREAM_TILE = 16  # the least default item_tile (pick_stream_tile)

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


def _cuda_operands(user_emb, item_emb, seen, k, what):
    dev = _check_cuda(user_emb, item_emb, seen, k, what)
    return (
        user_emb.contiguous(),
        item_emb.T.contiguous(),  # (D, I): coalesced item reads
        seen.contiguous().view(torch.uint8),
        *_outputs(seen.shape[0], k, dev),
    )


def device_smem_limit(device: torch.device) -> int:
    return build.device_smem_limit(_LIB, device)


def fused_smem_bytes(n_items: int, d: int) -> int:
    """Dynamic shared memory of one one-shot block (retrieval.cu)."""
    return 4 * ROWS * (d + n_items)


def stream_smem_bytes(k: int, tile: int) -> int:
    """Dynamic shared memory of one streaming block with its long lists in
    it (retrieval.cu ``StreamSmem``, whose ``streaming_smem_bytes`` gives the
    same; the launcher places the lists that do not fit the device's limit
    in device memory): three staged slices of 16 x (32
    users + 128 items) floats and four counters a user; per user a
    survivor area of one step plus ``tile`` entries (key, id); per warp a
    fold's ranked survivors; then the long lists, per user the running
    top-k and per warp a fold's merged list. The embedding width does not
    enter: the operands are staged 16 deep."""
    area = STREAM_STEP + tile
    return 4 * (STREAM_SLICES * STREAM_SLICE * (STREAM_USERS + STREAM_STEP) + 4 * STREAM_USERS
                + STREAM_USERS * 2 * area + 8 * 2 * min(area, k) + (STREAM_USERS + 8) * 2 * k)


def fits_smem_retrieval(n_items: int, d: int, smem_limit: int) -> bool:
    """True when the one-shot kernel's score rows fit one block's shared
    memory (``smem_limit``: the device's opt-in limit per block)."""
    return fused_smem_bytes(n_items, d) <= smem_limit


def pick_stream_tile(k: int) -> int:
    """The streaming kernel's default ``item_tile``: the survivors a user
    absorbs between folds. A fold ranks its survivors pairwise (the square
    of the tile) and merges them into the k-entry running list (k), so the
    best tile grows with k: on an H100 at 6040 x 49,410 x 64
    (``tools/kernel_ab.py``, PERF.md) 16 was the fastest of 1 to 64 at
    k=100, and 128 of 16 to 128 at k=1000. k / 8, at least ``STREAM_TILE``
    and at most 256 (a block's survivor areas stay in shared memory)."""
    return max(STREAM_TILE, min(256, k // 8))


def stream_parts(n_users: int, n_items: int, n_sms: int) -> Tuple[int, int]:
    """(parts, part_len): how the streaming kernel splits the catalog. The
    fewest parts (of whole 128-item steps) whose blocks spread over the SMs
    at least 90% evenly (blocks / (SMs x the most blocks an SM gets)), at
    most 32, then rounded to whole steps per part; the user groups alone
    give 189 blocks at 6040 users, 1.4 an SM on 132 SMs."""
    return spread_parts(-(-n_users // STREAM_USERS), -(-n_items // STREAM_STEP), STREAM_STEP,
                        n_sms)


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


def _padded_t(t: torch.Tensor) -> torch.Tensor:
    """t (n, D) as its (D, n) transpose with rows padded by zeros to a
    multiple of 4 floats (16-byte copies)."""
    n = t.shape[0]
    return torch.nn.functional.pad(t.T, (0, -n % 4)).contiguous()


def streaming_topk_retrieval(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    seen: torch.Tensor,
    k: int,
    item_tile: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_topk_retrieval`` without its catalog cap: blocks of 32 users
    score 128-item steps and keep a running top-k, so shared memory does not
    grow with I; a large k's lists that do not fit a block's shared memory
    go to a workspace in device memory. ``item_tile`` is how many survivors of
    the running k-th a user absorbs between folds; ``None`` takes
    ``pick_stream_tile(k)``. Any tile gives the same result."""
    if user_emb.device.type == "cpu":
        return fused_topk_retrieval_ref(user_emb, item_emb, seen, k)
    dev = _check_cuda(user_emb, item_emb, seen, k, "streaming_topk_retrieval")
    (U, D), I = user_emb.shape, item_emb.shape[0]
    tile = pick_stream_tile(k) if item_tile is None else item_tile
    if tile < 1:
        raise ValueError(f"streaming_topk_retrieval: item_tile {tile} must be >= 1")
    parts, part_len = stream_parts(U, I, _sm_count(dev))
    uT, itT = _padded_t(user_emb), _padded_t(item_emb)
    seen8 = seen.contiguous().view(torch.uint8)
    idx, vals = _outputs(U, k, dev)
    n_part = parts * U * k if parts > 1 else 0
    part_idx = torch.empty(n_part, dtype=torch.int32, device=dev)
    part_val = torch.empty(n_part, dtype=torch.float32, device=dev)
    lib, fn = _stream_launcher()
    limit = device_smem_limit(dev)
    per_block = lib.streaming_workspace_bytes(k, tile, limit)
    if per_block < 0:
        raise ValueError(f"streaming_topk_retrieval: item_tile {tile} leaves no block "
                         f"within {limit} B of shared memory")
    ws = None
    if per_block:  # the long lists that do not fit shared memory
        blocks = -(-U // STREAM_USERS) * parts
        ws = torch.empty(blocks * per_block // 4, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = fn(uT.data_ptr(), uT.shape[1], itT.data_ptr(), itT.shape[1], seen8.data_ptr(),
                U, I, D, k, tile, parts, part_len, limit,
                None if ws is None else ws.data_ptr(), part_idx.data_ptr(),
                part_val.data_ptr(), idx.data_ptr(), vals.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "streaming_topk_retrieval")
    streaming_topk_retrieval.launches += 1
    if parts > 1:
        streaming_topk_retrieval.merge_launches += 1
    return idx, vals


streaming_topk_retrieval.launches = 0
streaming_topk_retrieval.merge_launches = 0


@functools.lru_cache(maxsize=None)
def _stream_launcher():
    """(library, launcher) of the streaming kernel, its C types bound once."""
    lib = build.load_library(_LIB)
    lib.streaming_smem_bytes.argtypes = [_INT, _INT]
    lib.streaming_workspace_bytes.argtypes = [_INT, _INT, _INT]
    lib.streaming_smem_bytes.restype = ctypes.c_longlong
    lib.streaming_workspace_bytes.restype = ctypes.c_longlong
    fn = lib.streaming_topk_retrieval_launch
    fn.argtypes = [_PTR, _INT, _PTR, _INT, _PTR] + [_INT] * 8 + [_PTR] * 6
    fn.restype = _INT
    return lib, fn


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count

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
A and W into bf16 parts (two a call, three when A is not exact in bf16;
one a block of W's items where serving builds the parts from the edges,
``kernel_operands``); a launch captured into a CUDA graph counts at each
replay (``ops/cuda/launches``).

Serving builds the kernel's operands from the train+val edges here
(``kernel_operands``), which also chooses the walk of the contraction
F = A.W (``compact_walk``): over all I (the dense walk) or over each
128-user block's own items (the compacted walk, ``fusion_serve.cu``'s
header); ``fused_serve_parts`` launches the kernel on them.
``fused_lgcnhs_serve.compact_launches`` counts the launches of the
compacted walk; ``.k_rows`` and ``.k_rows_dense`` the contraction rows
the launches walked (over the blocks) and the rows the dense walk would
have walked. A compacted launch's rows are a value on the card, read
after the launch, a read that waits for it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple, Union

import torch

from lgcnhs_tpu_torch.ops.cuda import build
from lgcnhs_tpu_torch.ops.cuda.launches import count, count_launch
from lgcnhs_tpu_torch.ops.cuda.retrieval import _padded_t, _sm_count, spread_parts
from lgcnhs_tpu_torch.ops.diffusion import edge_spreading, transfer_block
from lgcnhs_tpu_torch.ops.topk import select_topk
from lgcnhs_tpu_torch.runtime.logging import span

EXCLUDED = -3.0e38
BLOCK_USERS = 128  # users a block, fusion_serve.cu kBM
BLOCK_ITEMS = 128  # items a tile, kBN
CHUNK = 32  # contraction depth of one staged chunk, kKC
STAGES = 4  # chunks in the copy ring, kStages
W_PARTS = 3  # bf16 parts of W, kWP
G_SLICE = 16  # depth of one staged slice of the G operands, kGD
WARPS = 8
# Items a block of W's parts: ML-1M's catalog is one block, Gowalla's ten;
# a block's (I, b) f32 product stays near 1.5 GB at 91,599 items.
W_BLOCK = 4096
# The compacted walk's bound, a share of the catalog: it is taken where a
# user block's rows, 128 n / U on average (its items are at most its rows),
# are at most this share of I. ML-1M reads 5.2 and is dense; Gowalla 0.097
# and Amazon-Book 0.071 compact.
COMPACT_SHARE = 0.5

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
    out = torch.empty((n, x.shape[0], ld), dtype=torch.bfloat16, device=x.device)
    bf16_parts_into(x, out)
    return out


def bf16_parts_into(x: torch.Tensor, out: torch.Tensor) -> None:
    """``bf16_parts(x, n, ld)`` written into ``out``, (n, rows, ld), which
    may be a block of rows of a larger parts buffer."""
    rows, cols = x.shape
    out[:, :, cols:] = 0
    step = max(1, (1 << 26) // max(cols, 1))
    for r0 in range(0, rows, step):
        rest = x[r0:r0 + step].float().contiguous()
        for p in range(out.shape[0] - 1):
            part = (rest.view(torch.int32) & -65536).view(torch.float32)
            out[p, r0:r0 + step, :cols] = part  # exact: 8 significand bits
            rest = rest - part  # exact: the bits below them
        out[-1, r0:r0 + step, :cols] = rest


def parts_ld(n_items: int) -> int:
    """The row stride of the kernel's bf16 parts: I rounded up to 64
    entries, so rows start on 128-byte lines and no 64-byte chunk
    straddles two."""
    return n_items + (-n_items % 64)


class CompactOperands(NamedTuple):
    """A on the compacted walk. For block b of 128 users, J_b: the sorted
    items of its users' rows, padded with item 0 to a multiple of 32
    columns; A's block rows restricted to J_b, zero in the padding and in
    the rows of users past U. Every size is set by (U, n) alone
    (``compact_operands``), so building it waits for nothing."""
    col_ptr: torch.Tensor  # (blocks + 1,) int32: block b's columns col_ptr[b] .. col_ptr[b + 1] - 1
    cols: torch.Tensor  # (n + 31 blocks,) int32: each column's item; past col_ptr[-1] unused
    a_cols: torch.Tensor  # (128 (n + 31 blocks),) bf16: block b's 128 rows of its |J_b| entries,
    #                      K-major, from 128 col_ptr[b]


class ServeOperands(NamedTuple):
    """The kernel's operands: the transposed tables (rows padded to 4
    floats) and the bf16 parts of A and W (rows padded to 64 entries). On
    the compacted walk (``compact``) ``a_parts`` is A's ``CompactOperands``
    and ``w_parts`` W's own parts, N-major."""
    uT: torch.Tensor  # (D, ldu) f32
    itT: torch.Tensor  # (D, ldi) f32
    a_parts: Union[torch.Tensor, CompactOperands]  # (1 or 3, U, ldk) bf16
    w_parts: torch.Tensor  # (3, I, ldw) bf16, parts of W^T (of W on the compacted walk)
    compact: bool = False  # the walk


def serve_operands(user_emb, item_emb, A, W) -> ServeOperands:
    """Splits A and W once per call: W^T always in three parts (both
    operands of the product K-major); A in one when every entry is exact in
    bf16 (the 0/1 interaction matrix of the serving path), else in three.
    On the card the split is the one-pass ``bf16_parts_kernel``
    (``fused_lgcnhs_serve.split_launches`` counts its launches), which
    flags an A that one part does not hold; one int is read back, and only
    such an A is split again. Else ``bf16_parts``."""
    ld = parts_ld(W.shape[0])
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
                  inexact: Optional[torch.Tensor] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``bf16_parts(x.T if transpose else x, n, ld)`` by the library's
    kernel, in one pass over x. With n = 1 and ``inexact`` (one int32 on
    the card, zero), the kernel sets it to 1 where an entry is not exact
    in bf16. With ``out``, (n, rows, ld) with unit column and ld row
    strides (a block of rows of a larger parts buffer), the parts are
    written there."""
    rows, cols = x.shape
    x = x.contiguous()
    if out is None:
        out = torch.empty((n, cols if transpose else rows, ld), dtype=torch.bfloat16,
                          device=x.device)
    if out.shape != (n, cols if transpose else rows, ld) or out.stride()[1:] != (ld, 1):
        raise ValueError(f"split_on_card: out {tuple(out.shape)}, strides {out.stride()}")
    lib, _ = _launcher()
    with torch.cuda.device(x.device):
        rc = lib.bf16_parts_launch(x.data_ptr(), rows, cols, ld, n, int(transpose),
                                   out.stride(0), out.data_ptr(),
                                   None if inexact is None else inexact.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "bf16_parts")
    count_launch(fused_lgcnhs_serve, "split_launches")
    return out


def _split_rows_into(x: torch.Tensor, out: torch.Tensor) -> None:
    """The three bf16 parts of x^T, x (rows, b) f32, into ``out`` (3, b,
    ld), a block of rows of a parts buffer: on the card by
    ``split_on_card``'s transposing pass, else ``bf16_parts_into``."""
    if x.device.type == "cuda":
        split_on_card(x, W_PARTS, out.shape[2], transpose=True, out=out)
    else:
        bf16_parts_into(x.T, out)


def _split_cols_into(x: torch.Tensor, out: torch.Tensor) -> None:
    """The three bf16 parts of x, (rows, b) f32, into ``out`` (3, rows, b),
    a block of columns of a parts buffer (unit column stride): on the card
    by ``bf16_parts_cols_launch``, one pass, else ``bf16_parts_into``."""
    if x.device.type != "cuda":
        bf16_parts_into(x, out)
        return
    rows, cols = x.shape
    x = x.contiguous()
    lib, _ = _launcher()
    with torch.cuda.device(x.device):
        rc = lib.bf16_parts_cols_launch(x.data_ptr(), rows, cols, out.stride(1), out.stride(0),
                                        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check_launch(lib, rc, "bf16_parts_cols")
    count_launch(fused_lgcnhs_serve, "split_launches")


def compact_operands(n_users: int, n_items: int, edges: torch.Tensor) -> CompactOperands:
    """A's ``CompactOperands`` from a (2, n) ``edge_array`` of (user,
    item) rows on its device, rows repeated or not: the rows sorted by
    (block, item, user), each (block, item) pair numbered within its
    block by a running count of the pairs' first rows, the blocks' widths
    padded and summed into ``col_ptr``, then each pair's item scattered
    into ``cols`` and each row's 1 filled into ``a_cols``. Every array is
    sized from (U, n) alone (a block's items are at most its rows), so no
    step waits for the device."""
    dev = edges.device
    blocks = -(-n_users // BLOCK_USERS)
    bound = edges.shape[1] + (CHUNK - 1) * blocks
    users = edges[0].long()
    key = torch.sort(((users // BLOCK_USERS) * n_items + edges[1].long()) * BLOCK_USERS
                     + users % BLOCK_USERS).values
    pair = key // BLOCK_USERS  # block * I + item
    row = key - pair * BLOCK_USERS
    block = pair // n_items
    first = torch.ones_like(pair)
    first[1:] = pair[1:] != pair[:-1]
    width = torch.zeros(blocks, dtype=torch.long, device=dev).index_add_(0, block, first)
    column = torch.cumsum(first, 0) - 1 - (torch.cumsum(width, 0) - width)[block]
    padded = (width + CHUNK - 1) // CHUNK * CHUNK
    col_ptr = torch.cat([padded.new_zeros(1), torch.cumsum(padded, 0)])
    start = col_ptr[block]
    cols = torch.zeros(bound, dtype=torch.int32, device=dev)
    cols.scatter_(0, start + column, (pair - block * n_items).int())
    a_cols = torch.zeros(BLOCK_USERS * bound, dtype=torch.bfloat16, device=dev)
    a_cols.index_fill_(0, BLOCK_USERS * start + row * padded[block] + column, 1.0)
    return CompactOperands(col_ptr.int(), cols, a_cols)


def compact_dense(ops: CompactOperands, n_users: int, n_items: int) -> torch.Tensor:
    """The (U, I) f32 A that ``ops`` holds: each block's columns added into
    its items (a padding column adds zeros to item 0)."""
    ptr = ops.col_ptr.tolist()
    A = torch.zeros(((len(ptr) - 1) * BLOCK_USERS, n_items), device=ops.a_cols.device)
    for b in range(len(ptr) - 1):
        block = ops.a_cols[BLOCK_USERS * ptr[b]:BLOCK_USERS * ptr[b + 1]]
        A[BLOCK_USERS * b:BLOCK_USERS * (b + 1)].index_add_(
            1, ops.cols[ptr[b]:ptr[b + 1]].long(), block.view(BLOCK_USERS, -1).float())
    return A[:n_users]


def compact_walk(n_users: int, n_items: int, n_rows: int) -> bool:
    """Whether kernel 4 walks each user block's items alone (its
    ``CompactOperands``) rather than the whole catalog, from the shapes of
    its input: U, I and the n train+val rows."""
    return BLOCK_USERS * n_rows <= COMPACT_SHARE * n_users * n_items


def positive_parts(n_users: int, n_items: int, edges: torch.Tensor):
    """(a_parts, seen) set on ``edges``' device from an ``edge_array``, as the
    kernel reads them: A's one bf16 part, (1, U, ld), 0/1 (exact in bf16)
    with zeros past column I, and the bool seen, (U, I); equal to
    ``data/graph.dense_positives``' A in bf16 and its seen. No (U, I) f32
    array: each is zeroed and filled at the rows' flat indices (int64)."""
    ld = parts_ld(n_items)
    users, items = edges[0].long(), edges[1].long()
    a_parts = torch.zeros((1, n_users, ld), dtype=torch.bfloat16, device=edges.device)
    a_parts.view(-1).index_fill_(0, users * ld + items, 1.0)
    seen = torch.zeros((n_users, n_items), dtype=torch.bool, device=edges.device)
    seen.view(-1).index_fill_(0, users * n_items + items, True)
    return a_parts, seen


class KernelOperands(NamedTuple):
    """The kernel's operands built from the edges (``kernel_operands``),
    on the walk chosen there: on the dense walk ``a`` is A's one bf16 part
    and ``w_parts`` W^T's parts; on the compacted walk ``a`` is A's
    ``CompactOperands`` and ``w_parts`` W's own parts, N-major."""
    a: Union[torch.Tensor, CompactOperands]  # (1, U, ld) bf16, or A's CompactOperands
    w_parts: torch.Tensor  # (3, I, ld) bf16, zero past column I
    seen: torch.Tensor  # (U, I) bool
    compact: bool  # the walk, ``compact_walk`` of the input
    w_blocks: int  # blocks of W's parts built


def kernel_operands(n_users: int, n_items: int, edges: torch.Tensor, lam) -> KernelOperands:
    """The operands of ``fused_serve_parts`` from the (2, n) train+val edge
    array on the device, with no (I, I) or (U, I) f32 array: A's one bf16
    part and seen (``positive_parts``, a ``serve.build``), then, in
    ``serve.transfer_matrix``, W's factors (``ops/diffusion.edge_spreading``)
    and W's three bf16 parts, (3, I, ld), one ``serve.w_block`` per
    ``W_BLOCK`` items j: W[:, j] from A's columns (``transfer_block``, one
    sparse product) split into the parts: rows j of W^T's, or on the
    compacted walk (``compact_walk``) columns j of W's own. Live at once:
    the parts, seen and one block's (U, b) and (I, b) f32. On the compacted
    walk A's ``CompactOperands`` (a ``serve.build``) are made once the
    block's arrays and A's part are freed, so they stay below the blocks'
    peak. Nothing waits for the device."""
    ld = parts_ld(n_items)
    compact = compact_walk(n_users, n_items, edges.shape[1])
    with span("serve.build"):
        a, seen = positive_parts(n_users, n_items, edges)
    with span("serve.transfer_matrix"):
        spread = edge_spreading(n_users, n_items, edges, lam)
        w_parts = torch.empty((W_PARTS, n_items, ld), dtype=torch.bfloat16, device=edges.device)
        if compact:
            w_parts[:, :, n_items:] = 0
        starts = range(0, n_items, W_BLOCK)
        for j0 in starts:
            with span("serve.w_block"):
                j1 = min(j0 + W_BLOCK, n_items)
                W_cols = transfer_block(spread, a[0, :, j0:j1], j0)
                if compact:
                    _split_cols_into(W_cols, w_parts[:, :, j0:j1])
                else:
                    _split_rows_into(W_cols, w_parts[:, j0:j1])
                del W_cols
    if compact:
        del spread, a
        with span("serve.build"):
            a = compact_operands(n_users, n_items, edges)
    return KernelOperands(a, w_parts, seen, compact, len(starts))


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
    return _launch_counted(serve_operands(user_emb, item_emb, A, W), seen, k)


def fused_serve_parts(
    user_emb: torch.Tensor,  # (U, D) f32 layer-0 user table
    item_emb: torch.Tensor,  # (I, D) f32 layer-0 item table
    ops: KernelOperands,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``fused_lgcnhs_serve`` on ``kernel_operands``' value, along the walk
    it holds, counted as its launches. Given CPU tensors, the twin on the
    parts' sums."""
    U, I = user_emb.shape[0], item_emb.shape[0]
    if tuple(ops.seen.shape) != (U, I) or not 1 <= k <= I:
        raise ValueError(f"fused_serve_parts: operands of {tuple(ops.seen.shape)} for tables "
                         f"of {U} users and {I} items, k {k}")
    if user_emb.device.type == "cpu":
        A = compact_dense(ops.a, U, I) if ops.compact else ops.a.float().sum(0)[:, :I]
        W = ops.w_parts.float().sum(0)[:, :I]
        return fused_lgcnhs_serve_ref(user_emb, item_emb, A, W if ops.compact else W.T,
                                      ops.seen, k)
    for name, t in (("user_emb", user_emb), ("item_emb", item_emb)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_serve_parts: {name} must be float32, got {t.dtype}")
    serve = ServeOperands(_padded_t(user_emb), _padded_t(item_emb), ops.a, ops.w_parts,
                          ops.compact)
    return _launch_counted(serve, ops.seen, k)


def _launch_counted(ops: ServeOperands, seen: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    lib, fn = _launcher()
    idx, vals, parts = launch_kernel(lib, fn, ops, seen, k)
    count_launch(fused_lgcnhs_serve)
    if parts > 1:
        count_launch(fused_lgcnhs_serve, "merge_launches")
    U, I = seen.shape
    dense_rows = -(-U // BLOCK_USERS) * -(-I // CHUNK) * CHUNK
    count(fused_lgcnhs_serve, "k_rows_dense", dense_rows)
    if ops.compact:
        count_launch(fused_lgcnhs_serve, "compact_launches")
        # a value on the card: the read waits for the launch
        count(fused_lgcnhs_serve, "k_rows", int(ops.a_parts.col_ptr[-1]))
    else:
        count(fused_lgcnhs_serve, "k_rows", dense_rows)
    return idx, vals


def launch_kernel(lib: ctypes.CDLL, fn, ops: ServeOperands, seen: torch.Tensor,
                  k: int) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One launch of the kernel of ``lib`` (``fn``: its launcher, typed by
    ``bind``) on prepared operands: (indices, values, catalog parts); with
    more than one part the launcher also ran the merge."""
    D, U = ops.uT.shape[0], seen.shape[0]
    I = ops.w_parts.shape[1]
    dev = seen.device
    plan = serve_plan(lib, U, I, k, 1 if ops.compact else ops.a_parts.shape[0], dev)
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
    tables = (ops.uT.data_ptr(), ops.uT.shape[1], ops.itT.data_ptr(), ops.itT.shape[1])
    rest = (ops.w_parts.data_ptr(), ops.w_parts.shape[2], seen8.data_ptr(),
            U, I, D, k, plan.parts, plan.part_len, plan.smem_limit,
            None if ws is None else ws.data_ptr(), part_idx.data_ptr(),
            part_val.data_ptr(), idx.data_ptr(), vals.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        a = ops.a_parts
        if ops.compact:
            rc = lib.fused_lgcnhs_serve_compact_launch(
                *tables, a.a_cols.data_ptr(), a.col_ptr.data_ptr(), a.cols.data_ptr(), *rest,
                stream)
        else:
            rc = fn(*tables, a.data_ptr(), a.shape[0], a.shape[2], *rest, stream)
    build.check_launch(lib, rc, "fused_lgcnhs_serve")
    return idx, vals, plan.parts


fused_lgcnhs_serve.launches = 0
fused_lgcnhs_serve.merge_launches = 0
fused_lgcnhs_serve.split_launches = 0
fused_lgcnhs_serve.compact_launches = 0
fused_lgcnhs_serve.k_rows = 0
fused_lgcnhs_serve.k_rows_dense = 0


def bind(lib: ctypes.CDLL):
    """Sets the C types of a library of ``fusion_serve.cu``; its launcher."""
    for name in ("fused_serve_smem_bytes", "fused_serve_workspace_bytes"):
        getattr(lib, name).argtypes = [_INT] * 3
        getattr(lib, name).restype = ctypes.c_longlong
    lib.fused_serve_resident_blocks.argtypes = [_INT] * 3
    lib.fused_serve_resident_blocks.restype = _INT
    lib.bf16_parts_launch.argtypes = [_PTR] + [_INT] * 5 + [ctypes.c_longlong] + [_PTR] * 3
    lib.bf16_parts_launch.restype = _INT
    if hasattr(lib, "fused_lgcnhs_serve_compact_launch"):  # older copies (tools/kernel_ab.py)
        lib.bf16_parts_cols_launch.argtypes = [_PTR, _INT, _INT] + [ctypes.c_longlong] * 2 \
            + [_PTR] * 2
        lib.bf16_parts_cols_launch.restype = _INT
        compact = lib.fused_lgcnhs_serve_compact_launch
        compact.argtypes = [_PTR, _INT, _PTR, _INT] + [_PTR] * 4 + [_INT, _PTR] + [_INT] * 7 \
            + [_PTR] * 6
        compact.restype = _INT
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

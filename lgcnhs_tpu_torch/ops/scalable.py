"""Memory-scalable ops: nothing here materializes an O(U*I) array.

Port of ``lgcnhs_tpu/ops/scalable.py``, the large-graph replacements of the
dense trainer's (U, I) matrices:

- negative-sampling rejection against a user-major CSR edge list instead of
  a dense ``pos_mask`` row gather (reference semantics: torch-geometric
  ``structured_negative_sampling``, ``model/LightGCN/loss.py:58``), drawing
  from the generator exactly as the dense samplers of
  ``models/lightgcn.py`` do, so a seed gives the identical triple stream;
- chunked masked top-k retrieval: each user chunk's seen mask is built on
  the tables' device from the CSR rows and ranked through
  ``ops/topk.retrieve_topk`` (the retrieval kernel on CUDA for f32 tables;
  reference ``model/LightGCN/evaluation.py:17-54`` scores the whole matrix);
- hit matrices for P/R/NDCG against CSR positives
  (``metrics/accurate.py:26-42``);
- Sorensen internal similarity over the co-occurrence Gram of the DISTINCT
  RECOMMENDED items only, built on the host with scipy, its pairs read on
  the lists' device (``metrics/diversity.py:66-115``).

Membership is an exact search of sorted int64 composite keys
``user << 32 | item`` (``csr_keys``): torch has int64 everywhere, where the
JAX module bisects each user's segment in 32 fixed steps because x64 is off
by default there. Same answers.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lgcnhs_tpu_torch.data.graph import EdgeSet
from lgcnhs_tpu_torch.models.lightgcn import _first_clean_candidate
from lgcnhs_tpu_torch.ops.topk import retrieval_route, retrieve_topk


def user_csr(n_users: int, es: EdgeSet) -> Tuple[np.ndarray, np.ndarray]:
    """User-major CSR of an edge set: (rowptr (U+1,) int32, cols (E,)
    int32), each user's items sorted and deduplicated (the dense 0/1
    ``interaction_matrix`` / ``pos_bool_matrix`` set, they do not add). Built
    by the native graph builder where it compiles, its numpy fallback
    otherwise (``native.bindings.build_csr``), as ``lgcnhs_tpu/ops/scalable.py:47``."""
    from lgcnhs_tpu_torch.native.bindings import build_csr

    indptr, indices = build_csr(np.asarray(es.users), np.asarray(es.items), n_users)
    return indptr.astype(np.int32), indices


def csr_keys(rowptr: np.ndarray, cols: np.ndarray, device) -> torch.Tensor:
    """The CSR's (user, item) pairs as ascending int64 keys
    ``user << 32 | item`` on ``device``: the sorted array every membership
    test here searches."""
    rowptr = np.asarray(rowptr, np.int64)
    rows = np.repeat(np.arange(rowptr.shape[0] - 1, dtype=np.int64), np.diff(rowptr))
    return torch.from_numpy((rows << 32) | np.asarray(cols, np.int64)).to(device)


def csr_contains(keys: torch.Tensor, users: torch.Tensor, items: torch.Tensor) -> torch.Tensor:
    """Boolean membership of each (users[i], items[i]) in the key set."""
    query = (users.long() << 32) | items.long()
    if keys.numel() == 0:
        return torch.zeros_like(query, dtype=torch.bool)
    pos = torch.searchsorted(keys, query).clamp_(max=keys.numel() - 1)
    return keys[pos] == query


def sample_bpr_batch_csr(
    generator: torch.Generator,
    edge_users: torch.Tensor,  # (E,) the deduped train edges
    edge_items: torch.Tensor,  # (E,)
    keys: torch.Tensor,  # ``csr_keys`` of the SAME split, for rejection
    batch_size: int,
    n_items: int,
    n_retries: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``models.lightgcn.sample_bpr_batch`` without the (U, I) ``pos_mask``:
    the same draws in the same order (one edge draw, one (n_retries, B)
    candidate draw, the first non-colliding candidate), so the triple
    stream is identical to the dense sampler's."""
    dev = edge_users.device
    idx = torch.randint(0, edge_users.shape[0], (batch_size,), generator=generator, device=dev)
    users = edge_users[idx]
    pos_items = edge_items[idx]
    cands = torch.randint(0, n_items, (n_retries, batch_size), generator=generator, device=dev)
    collide = csr_contains(keys, users[None, :].expand_as(cands), cands)
    return users, pos_items, _first_clean_candidate(cands, collide)


def sample_negatives_for_edges_csr(
    generator: torch.Generator,
    edge_users: torch.Tensor,  # (E,)
    edge_items: torch.Tensor,  # (E,)
    keys: torch.Tensor,  # ``csr_keys`` of the SAME split, for rejection
    n_items: int,
    n_retries: int = 8,
    reject_user_ids: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """CSR flavor of ``models.lightgcn.sample_negatives_for_edges``: every
    edge once, in order, one rejected negative each (the reference's
    ``calValLoss`` sampling, ``model/LightGCN/evaluation.py:68-77``), with
    the dense flavor's draws; ``reject_user_ids`` also rejects a candidate
    equal to the edge's user id (``contains_neg_self_loops=False``)."""
    cands = torch.randint(0, n_items, (n_retries, edge_users.shape[0]), generator=generator,
                          device=edge_users.device)
    collide = csr_contains(keys, edge_users[None, :].expand_as(cands), cands)
    if reject_user_ids:
        collide = collide | (cands == edge_users[None, :])
    return edge_users, edge_items, _first_clean_candidate(cands, collide)


def hits_csr(rec: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """(U, k) 0/1 f32 hit matrix: ``metrics_ops.hit_matrix`` against CSR
    positives instead of a dense (U, I) gather."""
    users = torch.arange(rec.shape[0], device=rec.device)[:, None].expand_as(rec)
    return csr_contains(keys, users, rec).to(torch.float32)


#: bytes a chunk of ``chunked_masked_topk`` may hold per (user, item) entry
CHUNK_BYTES = 256e6


def chunk_users(n_users: int, n_items: int, entry_bytes: int,
                chunk_bytes: float = CHUNK_BYTES) -> int:
    """Users a chunk of ``chunked_masked_topk`` takes: as many as keep its
    (C, I) block of ``entry_bytes``-byte entries within ``chunk_bytes``, at
    least 64 and at most all of them (the JAX rule, which counts 4 bytes,
    the f32 score block, on every route)."""
    return int(max(64, min(n_users, chunk_bytes / (entry_bytes * n_items))))


def chunked_masked_topk(
    user_emb: torch.Tensor,
    item_emb: torch.Tensor,
    rowptr: np.ndarray,
    cols: np.ndarray,
    k: int,
    chunk_bytes: float = CHUNK_BYTES,
) -> torch.Tensor:
    """(U, k) int32 masked top-k retrieval on the tables' device, one user
    chunk at a time: each chunk's (C, I) seen mask is set from its CSR rows
    on the device and ranked by ``ops/topk.retrieve_topk`` (one kernel
    launch a chunk on the kernel route). The ids are ``masked_topk``'s,
    lowest index first among ties; chunking the user axis cannot change a
    user's ids.

    Chunk rule: the chunk holds ``chunk_bytes`` of what the route keeps per
    (user, item) entry, ``chunk_users``: the 1-byte seen mask on the kernel
    route (the kernel never writes scores), the score's own bytes on the
    plain route (4 for f32, 8 for f64). The JAX package sizes every chunk
    by a 4-byte score block. ``cols`` may be a tensor already on the
    tables' device (a caller that ranks again stages it once)."""
    U, I = user_emb.shape[0], item_emb.shape[0]
    dev = user_emb.device
    route = retrieval_route(dev.type, user_emb.dtype)
    C = chunk_users(U, I, 1 if route == "kernel" else user_emb.element_size(), chunk_bytes)
    rowptr = np.asarray(rowptr, np.int64)
    cols_t = torch.as_tensor(cols).to(dev, torch.int64)
    out = torch.empty((U, k), dtype=torch.int32, device=dev)
    for s in range(0, U, C):
        e = min(s + C, U)
        out[s:e] = retrieve_topk(user_emb[s:e], item_emb, csr_rows_mask(rowptr, cols_t, s, e, I), k)
    return out


def csr_rows_mask(rowptr: np.ndarray, cols: torch.Tensor, start: int, stop: int,
                  n_cols: int) -> torch.Tensor:
    """(stop - start, n_cols) bool mask of CSR rows ``start:stop``, set on
    the device of ``cols`` (the CSR's int64 column ids, a tensor)."""
    dev = cols.device
    counts = torch.from_numpy(np.diff(np.asarray(rowptr[start:stop + 1], np.int64))).to(dev)
    rows = torch.repeat_interleave(torch.arange(stop - start, device=dev), counts)
    mask = torch.zeros((stop - start, n_cols), dtype=torch.bool, device=dev)
    mask[rows, cols[int(rowptr[start]):int(rowptr[stop])]] = True
    return mask


#: pairs of one chunk of ``internal_similarity_csr`` (about 60 bytes each)
SIMILARITY_CHUNK_PAIRS = 1 << 22


def internal_similarity_csr(
    rec,  # (U, k) tensor (its device runs the pair gather) or array
    interaction_edges: Tuple[np.ndarray, np.ndarray],  # (users, items)
    n_users: int,
    n_items: int,
    item_deg: np.ndarray,  # (I,)
    chunk_pairs: int = SIMILARITY_CHUNK_PAIRS,
) -> float:
    """Exact Sorensen intra-list similarity (``metrics/diversity.py:66-115``,
    the math of ``metrics_ops.internal_similarity``) without the (I, I)
    co-occurrence matrix: the Gram A^T A only over the DISTINCT RECOMMENDED
    items, a scipy sparse product of the 0/1 interaction matrix on the host
    as in JAX; then each list's pair values are read from it and weighted
    by the items' inverse square-root degrees on ``rec``'s device (the
    card's, in training).

    The Gram's entries become sorted int64 keys ``a * R + b`` searched by
    ``torch.searchsorted``; the user axis runs in chunks of about
    ``chunk_pairs`` pairs, each list's pairs i < j once (the Gram is
    symmetric; equal ids count as the diagonal, which is left out), summed
    in f64. The JAX function gathers all U k^2 pairs on the host by
    bisection, diagonal included, then subtracts it: the same value up to
    f64 sum order. (Gathering the pairs on the host instead, as JAX does,
    takes ~14x as long at 50,000 users and k=100 on an H100 machine:
    ``tools/iak_ab.py``.)"""
    import scipy.sparse as sp

    rec = torch.as_tensor(rec)
    dev = rec.device
    U, k = rec.shape
    uniq, inv = np.unique(rec.cpu().numpy().ravel(), return_inverse=True)
    eu, ei = interaction_edges
    A = sp.csr_matrix((np.ones(len(eu), np.float32), (eu, ei)), shape=(n_users, n_items))
    A.data[:] = 1.0  # duplicate edges sum in the COO -> CSR build; the reference
    # interaction matrix is 0/1 (utils/trans.py:13-29)
    Asub = A[:, uniq]  # (U, R)
    G = (Asub.T @ Asub).tocsr()  # (R, R) co-occurrence of the recommended items
    G.sort_indices()
    R = uniq.shape[0]
    rows = np.repeat(np.arange(R, dtype=np.int64), np.diff(G.indptr))
    keys = torch.from_numpy(rows * R + G.indices).to(dev)  # ascending
    vals = torch.from_numpy(G.data.astype(np.float64)).to(dev)
    del A, Asub, G, rows

    deg = np.asarray(item_deg, np.float64)[uniq]
    with np.errstate(divide="ignore"):
        inv_sqrt = torch.from_numpy(np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0)).to(dev)
    ridx = torch.from_numpy(inv.reshape(U, k).astype(np.int64)).to(dev)
    iu, ju = torch.triu_indices(k, k, 1, device=dev)
    users_per = max(1, chunk_pairs // max(1, iu.shape[0]))
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(0, U, users_per):
        r = ridx[s:s + users_per]
        a, b = r[:, iu].reshape(-1), r[:, ju].reshape(-1)
        query = a * R + b
        if keys.numel():
            pos = torch.searchsorted(keys, query).clamp_(max=keys.numel() - 1)
            found = (keys[pos] == query) & (a != b)
            total += (torch.where(found, vals[pos], 0.0) * inv_sqrt[a] * inv_sqrt[b]).sum()
    return 2.0 * total.item() / (U * k * (k - 1))

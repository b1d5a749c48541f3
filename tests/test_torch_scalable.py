"""The port's large-graph ops (``lgcnhs_tpu_torch/ops/scalable.py``) against
``lgcnhs_tpu/ops/scalable.py`` and against the port's dense counterparts,
on the same numpy-seeded inputs.

Tolerances: the CSR structures, samples, hits and ids are compared exactly
(ids on dyadic tables, whose f32 scores are exact in any summation order,
so ties are real and resolved to the lowest index by both packages);
``internal_similarity_csr`` to 1e-12 relative against JAX's (both sum f64
products of exact counts, in another order), and to 1e-5 relative against
the dense f32 ``internal_similarity``.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_checks import dyadic  # noqa: E402

from lgcnhs_tpu.data.graph import EdgeSet as JEdgeSet
from lgcnhs_tpu.ops import scalable as jscalable
from lgcnhs_tpu_torch.data.graph import EdgeSet, interaction_matrix, item_degrees, pos_bool_matrix
from lgcnhs_tpu_torch.models.lightgcn import sample_bpr_batch, sample_negatives_for_edges
from lgcnhs_tpu_torch.ops import metrics_ops
from lgcnhs_tpu_torch.ops import scalable as tscalable
from lgcnhs_tpu_torch.ops.topk import masked_topk

U, I = 60, 170


def _edges(seed=0, n=900, dups=False):
    """A random edge set; with ``dups`` every tenth edge repeated."""
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, U, n), rng.integers(0, I, n)]), axis=1)
    pairs = pairs[:, rng.permutation(pairs.shape[1])]
    if dups:
        pairs = np.concatenate([pairs, pairs[:, ::10]], axis=1)
    return EdgeSet(pairs[0].astype(np.int32), pairs[1].astype(np.int32))


def _keys(es, n_users=U):
    return tscalable.csr_keys(*tscalable.user_csr(n_users, es), "cpu")


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int64))


@pytest.mark.parametrize("seed,dups", [(0, False), (1, True), (2, True)])
def test_user_csr_identical_to_jax(seed, dups):
    es = _edges(seed, dups=dups)
    want = jscalable.user_csr(U, JEdgeSet(es.users, es.items))
    got = tscalable.user_csr(U, es)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    # sorted deduplicated rows: the set of pos_bool_matrix
    rowptr, cols = got
    dense = np.zeros((U, I), bool)
    dense[np.repeat(np.arange(U), np.diff(rowptr)), cols] = True
    np.testing.assert_array_equal(dense, pos_bool_matrix(U, I, es))
    assert all((np.diff(cols[rowptr[u]:rowptr[u + 1]]) > 0).all() for u in range(U))


def test_csr_contains_is_exact_membership():
    es = _edges(3, dups=True)
    keys = _keys(es)
    rng = np.random.default_rng(4)
    users, items = rng.integers(0, U, 5000), rng.integers(0, I, 5000)
    got = tscalable.csr_contains(keys, _t(users), _t(items)).numpy()
    np.testing.assert_array_equal(got, pos_bool_matrix(U, I, es)[users, items])
    empty = tscalable.csr_keys(np.zeros(U + 1, np.int32), np.zeros(0, np.int32), "cpu")
    assert not tscalable.csr_contains(empty, _t(users), _t(items)).any()


def test_csr_sampler_draws_the_dense_triples():
    es = _edges(5)
    keys = _keys(es)
    pos = torch.from_numpy(pos_bool_matrix(U, I, es))
    eu, ei = _t(es.users), _t(es.items)
    for seed in range(5):
        d = sample_bpr_batch(torch.Generator().manual_seed(seed), eu, ei, pos, 256, I)
        s = tscalable.sample_bpr_batch_csr(torch.Generator().manual_seed(seed), eu, ei, keys,
                                           256, I)
        for a, b in zip(d, s):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        assert not pos[s[0], s[2]].any()  # never a positive


@pytest.mark.parametrize("reject_user_ids", [False, True])
def test_all_edges_csr_sampler_draws_the_dense_negatives(reject_user_ids):
    """Every edge once, in order, the dense flavor's negatives; with
    ``reject_user_ids`` no negative equals its edge's user id (U ~ I, so
    the unrejected stream has such collisions)."""
    es = _edges(9)
    keys = _keys(es)
    pos = torch.from_numpy(pos_bool_matrix(U, I, es))
    eu, ei = _t(es.users), _t(es.items)
    collided = False
    for seed in range(6):
        du, dp, dn = sample_negatives_for_edges(torch.Generator().manual_seed(seed), eu, ei,
                                                pos, I, reject_user_ids=reject_user_ids)
        su, sp, sn = tscalable.sample_negatives_for_edges_csr(
            torch.Generator().manual_seed(seed), eu, ei, keys, I,
            reject_user_ids=reject_user_ids)
        torch.testing.assert_close(su, eu, rtol=0, atol=0)
        torch.testing.assert_close(sp, ei, rtol=0, atol=0)
        torch.testing.assert_close(sn, dn, rtol=0, atol=0)
        assert not pos[su, sn].any()
        collided |= bool((sn == eu).any())
        if reject_user_ids:
            assert not (sn == eu).any()
    assert collided != reject_user_ids


def test_hits_csr_equals_hit_matrix():
    es = _edges(4, dups=True)
    rec = np.random.default_rng(5).integers(0, I, (U, 9)).astype(np.int32)
    got = tscalable.hits_csr(torch.from_numpy(rec), _keys(es))
    want = metrics_ops.hit_matrix(torch.from_numpy(rec),
                                  torch.from_numpy(pos_bool_matrix(U, I, es)))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    j_rowptr, j_cols = jscalable.user_csr(U, JEdgeSet(es.users, es.items))
    j_hits = jscalable.hits_csr(jnp.asarray(rec), jnp.asarray(j_rowptr), jnp.asarray(j_cols))
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_hits))


def test_chunk_rule():
    """The 1-byte mask of the kernel route, the score bytes of the plain
    route; at least 64 users and at most all of them."""
    assert tscalable.chunk_users(50_000, 30_000, 1) == 8533
    assert tscalable.chunk_users(50_000, 30_000, 4) == 2133  # the JAX rule's chunk
    assert tscalable.chunk_users(50_000, 30_000, 8) == 1066
    assert tscalable.chunk_users(50_000, 10_000_000, 4) == 64
    assert tscalable.chunk_users(100, 30, 4) == 100


@pytest.mark.parametrize("chunk_users", [64, 7, 13, 60, 1000])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_chunked_masked_topk_ids_identical_to_jax_and_masked_topk(chunk_users, dtype):
    """Many chunks with a ragged tail (7, 13), one chunk (60, 1000): the ids
    of the port's ``masked_topk`` and of JAX's ``chunked_masked_topk``, ties
    to the lowest index (dyadic tables tie often)."""
    es = _edges(1, dups=True)
    rowptr, cols = tscalable.user_csr(U, es)
    rng = np.random.default_rng(2)
    ue, ie = dyadic(rng, (U, 16)), dyadic(rng, (I, 16))
    k = 7
    np_dtype = np.float64 if dtype == "float64" else np.float32
    ue_t, ie_t = torch.from_numpy(ue.astype(np_dtype)), torch.from_numpy(ie.astype(np_dtype))
    entry = ue_t.element_size()  # the plain route's entry bytes
    got = tscalable.chunked_masked_topk(ue_t, ie_t, rowptr, cols, k,
                                        chunk_bytes=chunk_users * entry * I)
    assert got.dtype == torch.int32 and tuple(got.shape) == (U, k)
    want = masked_topk(ue_t @ ie_t.T, torch.from_numpy(pos_bool_matrix(U, I, es)), k)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    j = jscalable.chunked_masked_topk(jnp.asarray(ue), jnp.asarray(ie), rowptr, cols, k,
                                      chunk_bytes=chunk_users * 4 * I)
    np.testing.assert_array_equal(got.numpy(), j)


def _rec_lists(seed, k=8, repeat=False):
    rng = np.random.default_rng(seed)
    rec = np.stack([rng.choice(I, k, replace=False) for _ in range(U)]).astype(np.int32)
    if repeat:  # an id twice in a list: JAX counts those pairs as diagonal
        rec[::3, 1] = rec[::3, 0]
    return rec


@pytest.mark.parametrize("chunk_pairs,repeat", [(1 << 22, False), (57, False), (100, True)])
def test_internal_similarity_csr_matches_jax_and_dense(chunk_pairs, repeat):
    es = _edges(6, dups=True)
    rec = _rec_lists(7, repeat=repeat)
    deg = item_degrees(I, es)
    edges = (np.asarray(es.users), np.asarray(es.items))
    got = tscalable.internal_similarity_csr(rec, edges, U, I, deg, chunk_pairs=chunk_pairs)
    want = jscalable.internal_similarity_csr(rec, edges, U, I, deg)
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    if not repeat:
        dense = metrics_ops.internal_similarity(
            torch.from_numpy(rec), torch.from_numpy(interaction_matrix(U, I, es)),
            torch.from_numpy(deg))
        assert got == pytest.approx(float(dense), rel=1e-5)


def test_internal_similarity_csr_f64_against_the_pair_sum():
    """The definition itself, summed in f64 over every ordered pair i != j
    of each list: within 1e-12."""
    es = _edges(8)
    rec = _rec_lists(9)
    deg = item_degrees(I, es).astype(np.float64)
    A = interaction_matrix(U, I, es, dtype=np.float64)
    S = (A.T @ A) / np.sqrt(np.outer(deg, deg).clip(min=1)) * (np.outer(deg, deg) > 0)
    k = rec.shape[1]
    want = sum(S[a, b] for row in rec for i, a in enumerate(row) for j, b in enumerate(row)
               if i != j) / (U * k * (k - 1))
    got = tscalable.internal_similarity_csr(rec, (es.users, es.items), U, I, item_degrees(I, es))
    assert got == pytest.approx(want, rel=1e-12, abs=0)

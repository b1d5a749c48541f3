"""Port retrieval (the twin of the one CUDA retrieval kernel, which takes
the place of both Pallas kernels, and ``retrieve_topk``'s plain path) vs
the JAX package: ``masked_topk`` and the Pallas ``fused_topk_retrieval`` /
``streaming_topk_retrieval`` in interpret mode.

Dyadic, tie-heavy inputs (exact scores in f32) must give identical indices
and values, including a user whose every score lies below the -1024 seen
sentinel and a multi-tile streaming merge. Continuous inputs are held to
tie-equivalence: agreement >= 0.98 and every mismatched slot within 5e-4
relative under an f64 reference.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_checks import dyadic, tie_equivalence  # noqa: E402

from lgcnhs_tpu.ops import topk as jtopk
from lgcnhs_tpu.ops.pallas import retrieval as jret
from lgcnhs_tpu_torch.ops import topk as ttopk
from lgcnhs_tpu_torch.ops.cuda import retrieval as tret

U, I, D = 70, 300, 16
H100_SMEM_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100


def _sub_sentinel(ue, ie, seen):
    """User 0 scores below -1024 on every item and has seen nothing; user 1
    too, but with seen items, which then outrank every unseen one."""
    ie[:, 0] = 1.0 + np.abs(ie[:, 0])
    ue[:2] = 0.0
    ue[:2, 0] = -3000.0
    seen[0] = False
    seen[1] = False
    seen[1, [5, 17, 250]] = True


@pytest.fixture
def exact_problem():
    rng = np.random.default_rng(11)
    ue, ie = dyadic(rng, (U, D)), dyadic(rng, (I, D))
    seen = rng.random((U, I)) < 0.25
    _sub_sentinel(ue, ie, seen)
    return ue, ie, seen


def _jax_scores(ue, ie):
    return jnp.dot(jnp.asarray(ue), jnp.asarray(ie).T,
                   precision=jax.lax.Precision.HIGHEST)


def _port(ue, ie, seen, k, fn=tret.fused_topk_retrieval, **kw):
    idx, vals = fn(torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(seen), k, **kw)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    return idx.numpy(), vals.numpy()


@pytest.mark.parametrize("k", [1, 10, 100])
def test_twin_matches_masked_topk_exactly(exact_problem, k):
    ue, ie, seen = exact_problem
    want = np.asarray(jtopk.masked_topk(_jax_scores(ue, ie), jnp.asarray(seen), k))
    idx, vals = _port(ue, ie, seen, k)
    np.testing.assert_array_equal(idx, want)
    masked = np.where(seen, -1024.0, ue.astype(np.float64) @ ie.T.astype(np.float64))
    np.testing.assert_array_equal(vals, np.take_along_axis(masked, want, axis=1))
    # the sub-sentinel users: real ids, and user 1's seen items first
    assert ((idx[:2] >= 0) & (idx[:2] < I)).all()
    assert list(idx[1, :min(k, 3)]) == [5, 17, 250][:min(k, 3)]


@pytest.mark.parametrize("k", [1, 10, 100])
def test_twin_matches_pallas_fused_exactly(exact_problem, k):
    ue, ie, seen = exact_problem
    j_idx, j_vals = jret.fused_topk_retrieval(
        jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(seen), k, interpret=True
    )
    idx, vals = _port(ue, ie, seen, k)
    np.testing.assert_array_equal(idx, np.asarray(j_idx))
    np.testing.assert_array_equal(vals, np.asarray(j_vals))


@pytest.mark.parametrize("k,tile", [(10, 64), (100, 128), (37, 96)])
def test_streaming_twin_matches_pallas_streaming_exactly(exact_problem, k, tile):
    """The Pallas streaming kernel's multi-tile merge (I=300 over tiles of
    64..128) with exact ties across tile borders, against the port's one
    retrieval function, which takes its place."""
    ue, ie, seen = exact_problem
    j_idx, j_vals = jret.streaming_topk_retrieval(
        jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(seen), k,
        item_tile=tile, interpret=True,
    )
    idx, vals = _port(ue, ie, seen, k)
    np.testing.assert_array_equal(idx, np.asarray(j_idx))
    np.testing.assert_array_equal(vals, np.asarray(j_vals))


def test_all_tied_scores_lowest_index_first():
    ue = np.ones((4, 8), np.float32)
    ie = np.ones((20, 8), np.float32)
    seen = np.zeros((4, 20), bool)
    seen[:, 2] = True
    idx, _ = _port(ue, ie, seen, 5)
    np.testing.assert_array_equal(idx, np.tile([0, 1, 3, 4, 5], (4, 1)))


@pytest.mark.parametrize("k", [10, 100])
def test_twin_tie_equivalent_on_continuous_inputs(k):
    rng = np.random.default_rng(29)
    ue = rng.standard_normal((U, D)).astype(np.float32)
    ie = rng.standard_normal((I, D)).astype(np.float32)
    seen = rng.random((U, I)) < 0.2
    _sub_sentinel(ue, ie, seen)
    j_idx, _ = jret.fused_topk_retrieval(
        jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(seen), k, interpret=True
    )
    ref = np.where(seen, -1024.0, ue.astype(np.float64) @ ie.T.astype(np.float64))
    idx, _ = _port(ue, ie, seen, k)
    agreement, gap = tie_equivalence(np.asarray(j_idx), idx, ref)
    assert agreement >= 0.98 and gap <= 5e-4, (agreement, gap)


def test_retrieve_topk_plain_path_matches_jax(exact_problem):
    ue, ie, seen = exact_problem
    want = np.asarray(jtopk.retrieve_topk(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(seen), 10))
    got = ttopk.retrieve_topk(torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(seen), 10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_twin_and_count_no_launch(exact_problem):
    ue, ie, seen = exact_problem
    before = (tret.fused_topk_retrieval.launches, tret.fused_topk_retrieval.merge_launches)
    got = _port(ue, ie, seen, 10)
    want = tret.fused_topk_retrieval_ref(
        torch.from_numpy(ue), torch.from_numpy(ie), torch.from_numpy(seen), 10
    )
    np.testing.assert_array_equal(got[0], want[0].numpy())
    assert (tret.fused_topk_retrieval.launches,
            tret.fused_topk_retrieval.merge_launches) == before


@pytest.mark.parametrize("k", [0, I + 1])
def test_k_outside_the_catalog_raises(exact_problem, k):
    ue, ie, seen = exact_problem
    with pytest.raises(ValueError, match="k must be"):
        _port(ue, ie, seen, k)


def test_guards_size_against_the_block_limit():
    # the one-shot kernel (retrieval.cu TopkSmem): its block memory takes
    # neither the catalog nor the embedding width, only k. At k=100 two
    # staged slices (22,528 B), four ints a user (768), a 48-survivor buffer
    # for each of 48 users (18,432), the ranked survivors of 8 warps
    # (6,400), and the running and merge lists in shared memory (44,800).
    # An H100 SM has 233,472 B, 1 KB of it reserved a block: two such blocks
    # (16 warps) an SM, as the launcher's fused_topk_resident_blocks reports
    # on the card
    assert tret.topk_block_bytes(100, H100_SMEM_OPTIN) == (92_928, 0)
    # k=1: five blocks by shared memory (registers then decide); two up to
    # k=146 (2 x (115,328 + 1,024) <= 233,472), one from k=147
    assert tret.topk_block_bytes(1, H100_SMEM_OPTIN) == (42_240, 0)
    assert tret.topk_block_bytes(146, H100_SMEM_OPTIN) == (115_328, 0)
    assert tret.topk_block_bytes(147, H100_SMEM_OPTIN) == (115_776, 0)
    # one more entry of k is a (key, id) for each of 48 users and 8 warps
    assert (tret.topk_block_bytes(200, H100_SMEM_OPTIN)[0]
            - tret.topk_block_bytes(199, H100_SMEM_OPTIN)[0]) == 4 * 2 * (48 + 8)
    # the long lists stay in shared memory to k=407; past it the running
    # lists go to a device-memory workspace (48 users x k x 8 B a block), so
    # every k runs
    assert tret.topk_block_bytes(407, H100_SMEM_OPTIN)[1] == 0
    assert tret.topk_block_bytes(408, H100_SMEM_OPTIN)[1] == 4 * 48 * 2 * 408
    assert tret.topk_block_bytes(1000, H100_SMEM_OPTIN) == (113_920, 384_000)
    with pytest.raises(ValueError, match="a block needs"):
        tret.topk_block_bytes(100, 40_000)
    # k=1000 on the CPU: the twin, against JAX's masked_top_k
    rng = np.random.default_rng(9)
    ue, ie = dyadic(rng, (40, 8)), dyadic(rng, (1200, 8))
    seen = rng.random((40, 1200)) < 0.25
    got = _port(ue, ie, seen, 1000)[0]
    want = np.asarray(jtopk.masked_topk(_jax_scores(ue, ie), jnp.asarray(seen), 1000))
    assert got.shape == (40, 1000)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_users,n_items,resident,parts,part_len", [
    (6040, 3706, 2, 2, 1920),  # ML-1M: 126 user groups x 2 parts in 264 slots, one wave
    (943, 1682, 2, 7, 256),  # ML-100K: 20 groups x 7 two-step parts, 140 of 264 slots
    (6040, 49_410, 2, 2, 24_832),  # 252 blocks fill one wave 95% evenly
    (6040, 3706, 1, 1, 3712),  # one block an SM: 126 of 132 slots
    (40, 100, 2, 1, 128),
])
def test_topk_plan_fills_the_block_slots(n_users, n_items, resident, parts, part_len):
    """The one-shot kernel's catalog parts on 132 SMs holding ``resident``
    blocks each: spread evenly over waves where parts keep 32 steps, else
    as many as fit one wave; whole 128-item steps, every part non-empty."""
    assert tret.topk_plan(n_users, n_items, resident, 132) == (parts, part_len)
    assert part_len % tret.STEP == 0
    assert (parts - 1) * part_len < n_items <= parts * part_len


@pytest.mark.parametrize("n_users,n_items,parts", [(6040, 49_410, 2), (128, 16_384, 26),
                                                   (70, 1000, 8), (6040, 100, 1)])
def test_stream_parts_spread_blocks_evenly(n_users, n_items, parts):
    """``spread_parts`` (the kernel's split when parts keep 32 steps, and
    fused serving's) on 132 SMs for groups of 32 users: whole 128-item
    steps, every part non-empty, blocks spread about evenly (the rule aims
    at 90%; rounding parts to whole steps can cost some of it)."""
    groups = -(-n_users // 32)
    got, part_len = tret.spread_parts(groups, -(-n_items // 128), 128, 132)
    assert got == parts and part_len % tret.STEP == 0
    assert (got - 1) * part_len < n_items <= got * part_len
    blocks = groups * got
    assert got == -(-n_items // 128) or blocks / (-(-blocks // 132) * 132) >= 0.75


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_select_topk_orders_signed_zeros_like_xla(dtype, x64):
    """XLA's top_k ranks +0.0 above -0.0; a fused score G*0 carries G's
    sign, so the order decides real ties."""
    x = np.array([[0.0, -0.0, 0.0, -0.0, 1.0, -1.0, -0.0, 2.0]], dtype)
    x = np.concatenate([x, -x])
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), 8)
    got_v, got_i = ttopk.select_topk(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(np.signbit(got_v.numpy()), np.signbit(np.asarray(want_v)))


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)

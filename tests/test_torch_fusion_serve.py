"""Port fused LGCNHS serving (twin of the CUDA kernel, which is the plain
chain ``_serve_unfused`` runs) vs the JAX package: ``_serve_unfused`` and the
Pallas ``fused_lgcnhs_serve`` in interpret mode.

Dyadic inputs make G, F and G*F exact in f32, so indices and values must be
identical. A user with fewer than k unseen items is pinned to
``_serve_unfused`` (distinct ids, seen items lowest id first): the Pallas
kernel repeats an id in that tail. Continuous inputs are held to
tie-equivalence (agreement >= 0.98, mismatched slots within 5e-4 relative
under an f64 reference).
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_checks import dyadic, tie_equivalence  # noqa: E402

from lgcnhs_tpu.models import fusion as jfusion
from lgcnhs_tpu.models.lightgcn import LightGCNParams as JParams
from lgcnhs_tpu.ops.pallas.fusion_serve import fused_lgcnhs_serve as j_kernel
from lgcnhs_tpu_torch.models import fusion as tfusion
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams as TParams
from lgcnhs_tpu_torch.ops.cuda import fusion_serve as tserve

U, I, D = 70, 190, 16
SHORT_USER = 0  # fewer than k unseen items


def _problem(exact, seed=23):
    rng = np.random.default_rng(seed)
    if exact:
        ue, ie = dyadic(rng, (U, D)), dyadic(rng, (I, D))
        W = dyadic(rng, (I, I), lo=0, hi=4)
    else:
        ue = rng.standard_normal((U, D)).astype(np.float32)
        ie = rng.standard_normal((I, D)).astype(np.float32)
        W = (rng.random((I, I)) * 0.1).astype(np.float32)
    A = (rng.random((U, I)) < 0.15).astype(np.float32)
    A[SHORT_USER] = 1.0
    A[SHORT_USER, [3, 50, 121, 188]] = 0.0  # 4 unseen items
    seen = A > 0
    return ue, ie, A, W, seen


def _twin(ue, ie, A, W, seen, k):
    idx, vals = tserve.fused_lgcnhs_serve(*map(torch.from_numpy, (ue, ie, A, W, seen)), k)
    assert idx.dtype == torch.int32 and vals.dtype == torch.float32
    return idx.numpy(), vals.numpy()


@pytest.mark.parametrize("k", [1, 10, 100])
def test_twin_matches_serve_unfused_exactly(k):
    ue, ie, A, W, seen = _problem(exact=True)
    want = np.asarray(jfusion._serve_unfused(*map(jnp.asarray, (ue, ie, A, W, seen)), k))
    idx, vals = _twin(ue, ie, A, W, seen, k)
    np.testing.assert_array_equal(idx, want)
    f64 = [x.astype(np.float64) for x in (ue, ie, A, W)]
    fused = np.where(seen, -3.0e38, (f64[0] @ f64[1].T) * (f64[2] @ f64[3]))
    np.testing.assert_array_equal(vals, np.take_along_axis(fused, want, axis=1).astype(np.float32))


@pytest.mark.parametrize("k,tile", [(10, 64), (100, 32)])
def test_twin_matches_pallas_kernel_exactly(k, tile):
    ue, ie, A, W, seen = _problem(exact=True)
    j_idx, j_vals = j_kernel(*map(jnp.asarray, (ue, ie, A, W, seen)), k,
                             item_tile=tile, interpret=True)
    idx, vals = _twin(ue, ie, A, W, seen, k)
    full = (~seen).sum(axis=1) >= k  # users the Pallas tail quirk cannot touch
    assert full.sum() >= U - 1
    np.testing.assert_array_equal(idx[full], np.asarray(j_idx)[full])
    np.testing.assert_array_equal(vals[full], np.asarray(j_vals)[full])


def test_fewer_than_k_unseen_gives_distinct_ids_like_the_chain():
    """U=3, I=8, k=5, user 0 with 6 seen items: the Pallas kernel gives
    [7 6 0 0 0], the XLA chain (and the port) [7 6 0 1 2]."""
    rng = np.random.default_rng(0)
    ue = dyadic(rng, (3, 4))
    ie = dyadic(rng, (8, 4))
    W = dyadic(rng, (8, 8), lo=1, hi=4)
    A = np.zeros((3, 8), np.float32)
    A[0, :6] = 1.0
    A[1, [1, 4]] = 1.0
    seen = A > 0
    want = np.asarray(jfusion._serve_unfused(*map(jnp.asarray, (ue, ie, A, W, seen)), 5))
    idx, vals = _twin(ue, ie, A, W, seen, 5)
    np.testing.assert_array_equal(idx, want)
    assert len(set(idx[0])) == 5
    assert set(idx[0, :2]) == {6, 7}
    np.testing.assert_array_equal(idx[0, 2:], [0, 1, 2])
    assert (vals[0, 2:] == np.float32(-3.0e38)).all()


@pytest.mark.parametrize("k", [10, 100])
def test_twin_tie_equivalent_to_pallas_on_continuous_inputs(k):
    ue, ie, A, W, seen = _problem(exact=False, seed=41)
    j_idx, _ = j_kernel(*map(jnp.asarray, (ue, ie, A, W, seen)), k,
                        item_tile=64, interpret=True)
    idx, _ = _twin(ue, ie, A, W, seen, k)
    f64 = [x.astype(np.float64) for x in (ue, ie, A, W)]
    ref = np.where(seen, -3.0e38, (f64[0] @ f64[1].T) * (f64[2] @ f64[3]))
    full = (~seen).sum(axis=1) >= k
    agreement, gap = tie_equivalence(np.asarray(j_idx)[full], idx[full], ref[full])
    assert agreement >= 0.98 and gap <= 5e-4, (agreement, gap)


def test_never_recommends_seen_when_enough_unseen():
    ue, ie, A, W, seen = _problem(exact=False, seed=3)
    idx, _ = _twin(ue, ie, A, W, seen, 10)
    for u in range(U):
        if (~seen[u]).sum() >= 10:
            assert not seen[u, idx[u]].any()


def test_allocate_matrix_matches_jax():
    ue, ie, _, _, seen = _problem(exact=True)
    want = jfusion.allocate_matrix(JParams(jnp.asarray(ue), jnp.asarray(ie)), jnp.asarray(seen))
    got = tfusion.allocate_matrix(TParams(torch.from_numpy(ue), torch.from_numpy(ie)),
                                  torch.from_numpy(seen))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_take_the_twin_and_count_no_launch():
    ue, ie, A, W, seen = _problem(exact=True)
    before = tserve.fused_lgcnhs_serve.launches
    idx, _ = _twin(ue, ie, A, W, seen, 10)
    ref_idx, _ = tserve.fused_lgcnhs_serve_ref(*map(torch.from_numpy, (ue, ie, A, W, seen)), 10)
    np.testing.assert_array_equal(idx, ref_idx.numpy())
    assert tserve.fused_lgcnhs_serve.launches == before


def test_guard_sizes_against_the_block_limit():
    h100 = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100
    assert tserve.fits_smem_serve(3706, 64, h100)  # ML-1M
    assert not tserve.fits_smem_serve(20_000, 64, h100)

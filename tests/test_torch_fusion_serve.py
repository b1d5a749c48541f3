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
import inspect
import os
import re
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


H100_SMEM_OPTIN = 232_448  # cudaDevAttrMaxSharedMemoryPerBlockOptin on an H100


@pytest.mark.parametrize("k", [1, 100, 1000])
def test_block_memory_does_not_grow_with_the_catalog(k):
    """The kernel streams the catalog, so one block's memory is the same at
    3706 items as at 49,410 because nothing that sizes it takes the catalog
    size: not ``serve_block_bytes``, nor the launcher's exports in
    ``fusion_serve.cu``, which the chip smoke holds it equal to. The block
    fits an H100 at every k (long lists past shared memory go to the
    workspace)."""
    assert list(inspect.signature(tserve.serve_block_bytes).parameters) == \
        ["k", "a_parts", "smem_limit"]
    with open(os.path.join(os.path.dirname(tserve.__file__), "fusion_serve.cu")) as f:
        src = f.read()
    for name in ("fused_serve_smem_bytes", "fused_serve_workspace_bytes",
                 "fused_serve_resident_blocks"):
        params = re.search(rf'extern "C" [\w ]+ {name}\(([^)]*)\)', src).group(1)
        assert params == "int k, int na, int smem_limit", (name, params)
    for a_parts in (1, 3):
        smem, _ = tserve.serve_block_bytes(k, a_parts, H100_SMEM_OPTIN)
        assert smem <= H100_SMEM_OPTIN
    smem, ws = tserve.serve_block_bytes(k, 1, H100_SMEM_OPTIN)
    assert ws == (0 if k == 1 else 4 * 128 * 2 * k)  # past k=1 the running lists, 1 KB per k
    if k == 100:  # one block an SM at the main path's k
        assert smem == 153_600


@pytest.mark.parametrize("what", ["W", "A not exact in bf16"])
def test_bf16_parts_sum_back_to_the_input_bitwise(what):
    """Three bf16 parts, each the next 8 significand bits, sum back to the
    f32 input exactly (normal floats); columns past the input are zero. One
    part is the input rounded, exact where the input is (a 0/1 A)."""
    rng = np.random.default_rng(7)
    if what == "W":
        x = (rng.random((50, 37)) * 10.0 ** rng.integers(-30, 30, (50, 37))).astype(np.float32)
    else:
        x = ((rng.random((50, 37)) < 0.3) * rng.integers(1, 4096, (50, 37)) / 4096)
        x = x.astype(np.float32)
        assert not np.array_equal(torch.from_numpy(x).bfloat16().float().numpy(), x)
    xt = torch.from_numpy(x)
    parts = tserve.bf16_parts(xt, 3, 40)
    assert parts.dtype == torch.bfloat16 and tuple(parts.shape) == (3, 50, 40)
    assert torch.equal(parts.float().sum(0)[:, :37], xt)
    assert torch.equal((parts[0].float() + parts[1].float()) + parts[2].float(),
                       parts.float().sum(0))
    assert not parts[:, :, 37:].any()
    binary = torch.from_numpy((rng.random((50, 37)) < 0.3).astype(np.float32))
    assert torch.equal(tserve.bf16_parts(binary, 1, 40)[0].float()[:, :37], binary)


def test_serve_operands_split_w_transposed_in_three_and_binary_a_in_one():
    ue, ie, A, W, _ = _problem(exact=False)
    ops = tserve.serve_operands(*map(torch.from_numpy, (ue, ie, A, W)))
    ld = 192  # I = 190 rounded up to whole 128-byte rows of bf16
    assert tuple(ops.a_parts.shape) == (1, U, ld) and tuple(ops.w_parts.shape) == (3, I, ld)
    assert ops.uT.shape[1] % 4 == 0 and ops.itT.shape[1] % 4 == 0
    assert torch.equal(ops.w_parts.float().sum(0)[:, :I], torch.from_numpy(W).T)
    A_half = torch.from_numpy(A) * (1 + 2.0 ** -10)  # 11 significand bits
    assert tserve.serve_operands(*map(torch.from_numpy, (ue, ie)), A_half,
                                 torch.from_numpy(W)).a_parts.shape[0] == 3

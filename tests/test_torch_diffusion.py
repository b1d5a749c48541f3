"""Port diffusion operators vs the JAX package: W_gen, the three transfers
and F = A.W at lambda in {0, 0.5, 1}.

Tolerances: 1e-12 at f64 (JAX with x64, reordered f64 sums) and 1e-5
relative at f32 (sums of up to U positive terms in another order; every
entry is a sum of non-negative terms, so there is no cancellation).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lgcnhs_tpu.ops import diffusion as jd
from lgcnhs_tpu_torch.ops import diffusion as td

U, I = 70, 110
LAMBDAS = [0.0, 0.5, 1.0]


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


def _incidence(dtype):
    rng = np.random.default_rng(5)
    A = (rng.random((U, I)) < 0.08).astype(dtype)
    A[3] = 0  # a user with no interactions
    A[:, 7] = 0  # an item nobody touched
    return A


def _compare(A_np, lam, dtype_t, rtol, atol):
    A_j, A_t = jnp.asarray(A_np), torch.from_numpy(A_np)
    wg_j = jd.general_spreading_matrix(A_j)
    wg_t = td.general_spreading_matrix(A_t)
    np.testing.assert_allclose(wg_t.numpy(), np.asarray(wg_j), rtol=rtol, atol=atol)
    lam_j = jnp.asarray(lam, A_j.dtype)
    for j_fn, t_fn in ((jd.probs_transfer, td.probs_transfer),
                       (jd.heats_transfer, td.heats_transfer)):
        np.testing.assert_allclose(
            t_fn(A_t, wg_t).numpy(), np.asarray(j_fn(A_j, wg_j)), rtol=rtol, atol=atol
        )
    W_j = jd.hybrid_transfer(A_j, wg_j, lam_j)
    W_t = td.hybrid_transfer(A_t, wg_t, lam)
    assert W_t.dtype == dtype_t
    np.testing.assert_allclose(W_t.numpy(), np.asarray(W_j), rtol=rtol, atol=atol)
    np.testing.assert_allclose(
        td.resource(A_t, W_t).numpy(), np.asarray(jd.resource(A_j, W_j)), rtol=rtol, atol=atol
    )
    np.testing.assert_allclose(
        td.hybrid_resource(A_t, wg_t, lam).numpy(),
        np.asarray(jd.hybrid_resource(A_j, wg_j, lam_j)),
        rtol=rtol, atol=atol,
    )


@pytest.mark.parametrize("lam", LAMBDAS)
def test_diffusion_matches_jax_f64(lam, x64):
    _compare(_incidence(np.float64), lam, torch.float64, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("lam", LAMBDAS)
def test_diffusion_matches_jax_f32(lam):
    _compare(_incidence(np.float32), lam, torch.float32, rtol=1e-5, atol=0)


def test_hybrid_endpoints_are_probs_and_heats():
    A = torch.from_numpy(_incidence(np.float64))
    wg = td.general_spreading_matrix(A)
    torch.testing.assert_close(td.hybrid_transfer(A, wg, 1.0), td.probs_transfer(A, wg))
    torch.testing.assert_close(td.hybrid_transfer(A, wg, 0.0), td.heats_transfer(A, wg))

"""The spread models' pieces against the JAX package: the dataset quirks
(``models/spread.resolve_spread_variant``), the diffusion dispatch
(``ops/diffusion.choose_diffusion``, ``factored_fits``) and
``diffusion_scores_auto`` through each of its algorithms.

Each algorithm is forced by a small ``DENSE_TRANSFER_BUDGET_BYTES`` set in
both packages. F must be within 1e-5 relative of JAX's (f32 sums in
another order), and the ranked lists (``rank_exclude_seen_topk`` on each
package's own F) identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lgcnhs_tpu.models import spread as jspread
from lgcnhs_tpu.ops import diffusion as jdiff
from lgcnhs_tpu.ops.topk import rank_exclude_seen_topk as j_rank
from lgcnhs_tpu_torch.config import DATASETS
from lgcnhs_tpu_torch.models import spread as tspread
from lgcnhs_tpu_torch.ops import diffusion as tdiff
from lgcnhs_tpu_torch.ops.topk import rank_exclude_seen_topk as t_rank

U, I, BLOCK = 60, 256, 64
UI, II = U * I * 4, I * I * 4
# budgets (bytes) that force each algorithm at U x I in f32
BUDGETS = {
    "dense": 2 * II + 3 * UI,
    "factored": (U * U + 3 * U * I) * 4,
    "blocked": 3 * UI,
    "sharded": 3 * UI - 1,
}


@pytest.mark.parametrize("method", ["ProbS", "HeatS", "HybridS"])
@pytest.mark.parametrize("dataset", DATASETS)
def test_resolve_spread_variant_matches_jax(method, dataset):
    for lam in (0.3, 0.85):
        assert (tspread.resolve_spread_variant(method, dataset, lam)
                == jspread.resolve_spread_variant(method, dataset, lam))
    with pytest.raises(ValueError):
        tspread.resolve_spread_variant("LightGCN", dataset, 0.5)


def test_dispatch_matches_jax_on_a_grid():
    shapes = [(60, 256), (943, 1682), (6040, 3706), (6040, 49410), (2000, 3000),
              (100, 100_000), (50_000, 60_000), (1, 1)]
    budgets = [None, 10**6, 10**8, int(4e9), int(4e10)]
    for u, i in shapes:
        for itemsize in (4, 8):
            for budget in budgets:
                args = (u, i, itemsize, budget)
                assert tdiff.choose_diffusion(*args) == jdiff.choose_diffusion(*args), args
                assert tdiff.factored_fits(*args) == jdiff.factored_fits(*args), args
    # the two catalogs of the main path at the kept 4e9-byte budget
    assert tdiff.choose_diffusion(6040, 3706) == "dense"
    assert tdiff.choose_diffusion(6040, 49410) == "factored"


def test_budget_is_read_at_call_time(monkeypatch):
    for name, budget in BUDGETS.items():
        monkeypatch.setattr(tdiff, "DENSE_TRANSFER_BUDGET_BYTES", budget)
        assert tdiff.choose_diffusion(U, I) == name


def _inputs(seed):
    rng = np.random.default_rng(seed)
    A = (rng.random((U, I)) < 0.08).astype(np.float32)
    A[3] = 0.0  # a user with no interactions
    A[:, 7] = 0.0  # an item with no interactions
    return A


@pytest.mark.parametrize("transpose_w", [False, True])
@pytest.mark.parametrize("algo", ["dense", "factored", "blocked"])
def test_diffusion_scores_auto_matches_jax(algo, transpose_w, monkeypatch):
    monkeypatch.setattr(tdiff, "DENSE_TRANSFER_BUDGET_BYTES", BUDGETS[algo])
    monkeypatch.setattr(jdiff, "DENSE_TRANSFER_BUDGET_BYTES", BUDGETS[algo])
    assert tdiff.choose_diffusion(U, I) == jdiff.choose_diffusion(U, I) == algo
    for seed, lam in ((0, 0.6), (1, 0.01), (2, 1.0)):
        A = _inputs(seed)
        want = np.asarray(jdiff.diffusion_scores_auto(
            jnp.asarray(A), jnp.asarray(lam, jnp.float32), transpose_w=transpose_w, block=BLOCK))
        got = tdiff.diffusion_scores_auto(
            torch.from_numpy(A), torch.tensor(lam, dtype=torch.float32),
            transpose_w=transpose_w, block=BLOCK)
        assert got.dtype == torch.float32 and got.shape == (U, I)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)
        seen = A > 0
        np.testing.assert_array_equal(
            t_rank(got, torch.from_numpy(seen), 10).numpy(),
            np.asarray(j_rank(jnp.asarray(want), jnp.asarray(seen), 10)))


def test_algorithms_agree_with_dense():
    """The W-free algorithms against the dense chain within the port; the
    blocked one falls back to it (bitwise) when the block does not divide I."""
    A = torch.from_numpy(_inputs(4))
    lam = torch.tensor(0.6)
    dense = tdiff.diffusion_scores(A, lam)
    scale = float(dense.abs().max())
    for F in (tdiff.user_factored_diffusion_scores(A, lam),
              tdiff.blocked_diffusion_scores(A, lam, block=BLOCK)):
        torch.testing.assert_close(F, dense, rtol=1e-5, atol=1e-5 * scale)
    assert torch.equal(tdiff.blocked_diffusion_scores(A, lam, block=100), dense)


def test_sharded_choice_raises(monkeypatch):
    monkeypatch.setattr(tdiff, "DENSE_TRANSFER_BUDGET_BYTES", BUDGETS["sharded"])
    with pytest.raises(ValueError, match="ROADMAP queue 1 item 7"):
        tdiff.diffusion_scores_auto(torch.from_numpy(_inputs(0)), 0.6)


@pytest.mark.parametrize("method,dataset", [("ProbS", "movielens1m"), ("HeatS", "douban"),
                                            ("HybridS", "synthetic")])
def test_spread_scores_match_jax(method, dataset):
    A = _inputs(5)
    want = np.asarray(jspread.spread_scores(A, method, dataset, 0.6))
    got = tspread.spread_scores(torch.from_numpy(A), method, dataset, 0.6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())

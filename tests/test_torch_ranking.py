"""The spread ranker of the port (``ops/topk.rank_exclude_seen_topk`` and
``rank_exclude_seen``) against the JAX package's, on seeded numpy inputs:
identical indices in every case, at f32 and f64 (JAX under x64).

Cases (modelled on ``tests/test_topk.py``): dyadic scores with many exact
ties and signed zeros (``rank_exclude_seen_topk`` orders +0 above -0, as
XLA's ``top_k``; ``rank_exclude_seen`` sorts them as equal, as XLA's
sort), users with fewer than k unseen items (the backfill),
``filter_seen=False``, k above the catalog (clamped), negative scores, and
all-tied rows.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_checks import dyadic  # noqa: E402

from lgcnhs_tpu.ops import topk as jtopk
from lgcnhs_tpu_torch.ops import topk as ttopk


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


def _signed_zeros(rng, x):
    """A third of the entries set to +0 or -0 at random."""
    zero = rng.random(x.shape) < 0.33
    return np.where(zero, np.where(rng.random(x.shape) < 0.5, 0.0, -0.0), x).astype(x.dtype)


def _cases(dtype):
    rng = np.random.default_rng(11)
    U, I = 40, 64
    ties = dyadic(rng, (U, I)).astype(dtype)
    seen = rng.random((U, I)) < 0.3
    few = seen.copy()
    few[0] = True  # no unseen item: all k backfilled
    few[1, :60] = True  # 4 unseen < k
    few[2, 1:] = True  # exactly one unseen
    return {
        "dyadic ties": (ties, seen),
        "signed zeros": (_signed_zeros(rng, ties), seen),
        "backfill": (_signed_zeros(rng, ties), few),
        "continuous": (rng.standard_normal((U, I)).astype(dtype), seen),
        "negative": ((-np.abs(rng.standard_normal((U, I))) - 1e3).astype(dtype), seen),
        "all tied": (np.zeros((U, I), dtype), few),
    }


def _compare(dtype, name, k, filter_seen):
    scores, seen = _cases(dtype)[name]
    for jfn, tfn in ((jtopk.rank_exclude_seen_topk, ttopk.rank_exclude_seen_topk),
                     (jtopk.rank_exclude_seen, ttopk.rank_exclude_seen)):
        want = np.asarray(jfn(scores, seen, k, filter_seen))
        got = tfn(torch.from_numpy(scores), torch.from_numpy(seen), k, filter_seen)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{jfn.__name__} {name}")


NAMES = ["dyadic ties", "signed zeros", "backfill", "continuous", "negative", "all tied"]


@pytest.mark.parametrize("filter_seen", [True, False])
@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("name", NAMES)
def test_spread_ranker_matches_jax_f32(name, k, filter_seen):
    _compare(np.float32, name, k, filter_seen)


@pytest.mark.parametrize("name", NAMES)
def test_spread_ranker_matches_jax_f64(name, x64):
    for k, filter_seen in ((10, True), (10, False), (100, True)):
        _compare(np.float64, name, k, filter_seen)


def test_positive_zero_ranks_above_negative_zero():
    """Ties go to the highest index, but +0 beats -0 wherever it sits."""
    scores = torch.tensor([[0.0, -0.0, 0.0, -0.0, -1.0]])
    seen = torch.zeros_like(scores, dtype=torch.bool)
    got = ttopk.rank_exclude_seen_topk(scores, seen, 5, filter_seen=True)
    assert got.tolist() == [[2, 0, 3, 1, 4]]
    # the full-sort flavor sorts +0 and -0 as equal: highest index first
    assert ttopk.rank_exclude_seen(scores, seen, 5).tolist() == [[3, 2, 1, 0, 4]]


def test_backfill_takes_the_best_seen_items():
    scores = torch.tensor([[5.0, 4.0, 3.0, 2.0, 1.0]])
    seen = torch.tensor([[True, False, True, True, False]])
    got = ttopk.rank_exclude_seen_topk(scores, seen, 4)
    assert got.tolist() == [[1, 4, 0, 2]]

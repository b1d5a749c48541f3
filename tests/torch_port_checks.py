"""Shared checks of the PyTorch port's tests (not collected: no test_ prefix).

``tie_equivalence`` is the serve contract of ``tests/tpu_smoke.py``: two
top-k index lists agree slot for slot except where the slot's values, under
an independent f64 reference, are equal within a relative gap.
"""
import numpy as np


def tie_equivalence(want_idx, got_idx, ref_vals):
    """(agreement, max relative value gap over mismatched slots).

    ``ref_vals`` is the (U, I) f64 reference score matrix both index lists
    are read against."""
    want_idx, got_idx = np.asarray(want_idx), np.asarray(got_idx)
    rows = np.arange(want_idx.shape[0])[:, None]
    mism = want_idx != got_idx
    agreement = 1.0 - float(mism.mean())
    if not mism.any():
        return agreement, 0.0
    w = ref_vals[rows, want_idx][mism]
    g = ref_vals[rows, got_idx][mism]
    gap = np.abs(w - g) / (np.maximum(np.abs(w), np.abs(g)) + 1e-5)
    return agreement, float(gap.max())


def dyadic(rng, shape, lo=-4, hi=5, denom=8):
    """Values in {lo/denom, ..., (hi-1)/denom}: products and short sums are
    exact in f32, so every summation order gives the same scores, with many
    exact ties."""
    return (rng.integers(lo, hi, shape) / denom).astype(np.float32)

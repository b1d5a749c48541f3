"""Seeded synthetic dataset generation, in numpy.

Port of ``lgcnhs_tpu/data/synthetic.py``: the same ``default_rng`` draws in
the same order (user activity, users, items, ratings, timestamps), so a seed
gives the identical interaction table. A table is a dict of equal-length
column arrays instead of a DataFrame; pandas' ``drop_duplicates(keep="first")``
becomes ``np.unique`` on a (user, item) key with the first indices re-sorted.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

Columns = Dict[str, np.ndarray]


def synthesize_movielens_like(
    n_users: int = 943,
    n_items: int = 1682,
    n_interactions: int = 100_000,
    seed: int = 42,
    user_col: str = "user",
    item_col: str = "item",
) -> Columns:
    """Ratings in the MovieLens ``u.data`` schema (user, item, rating,
    timestamp), item popularity ~ Zipf and user activity ~ lognormal, with
    duplicate (user, item) pairs dropped keeping the first."""
    rng = np.random.default_rng(seed)

    item_pop = 1.0 / np.power(np.arange(1, n_items + 1), 0.9)
    item_pop /= item_pop.sum()
    user_act = rng.lognormal(mean=0.0, sigma=1.0, size=n_users)
    user_act /= user_act.sum()

    users = rng.choice(n_users, size=n_interactions, p=user_act)
    items = rng.choice(n_items, size=n_interactions, p=item_pop)
    rating = rng.integers(1, 6, size=n_interactions)
    timestamp = rng.integers(874_000_000, 893_000_000, size=n_interactions)

    key = users.astype(np.int64) * n_items + items
    _, first = np.unique(key, return_index=True)
    first.sort()
    return {
        user_col: users[first] + 1,  # ml-100k ids are 1-based
        item_col: items[first] + 1,
        "rating": rating[first],
        "timestamp": timestamp[first],
    }


def synthesize_features(n_rows: int, dim: int, seed: int) -> np.ndarray:
    """Dense feature table stand-in for the reference's engineered user/item
    features (``processing/handleMovielens.py:39-100``)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_rows, dim)).astype(np.float32)

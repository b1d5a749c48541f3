"""Frozen copy of the port's seeded generators (``lgcnhs_tpu_torch/data/synthetic.py``).

The benchmark's interaction tables and feature tables come from here, not
from the program, so that a later change to the program's generators
cannot move the benchmark's inputs. The same ``default_rng`` draws in the
same order: user activity ~ lognormal, items ~ Zipf(0.9), ratings,
timestamps; duplicate (user, item) pairs dropped keeping the first.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

Columns = Dict[str, np.ndarray]


def synthesize_movielens_like(n_users: int, n_items: int, n_interactions: int, seed: int,
                              zipf: float = 0.9) -> Columns:
    """Ratings in the MovieLens ``u.data`` schema (1-based user and item ids,
    rating, timestamp)."""
    rng = np.random.default_rng(seed)
    item_pop = 1.0 / np.power(np.arange(1, n_items + 1), zipf)
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
        "user": users[first] + 1,
        "item": items[first] + 1,
        "rating": rating[first],
        "timestamp": timestamp[first],
    }


def synthesize_features(n_rows: int, dim: int, seed: int) -> np.ndarray:
    """A dense (n_rows, dim) float32 feature table, standard normal."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n_rows, dim)).astype(np.float32)

"""The split and the graph, worked out again from the interaction table.

Plain numpy, independent of the program: the semantics of the reference
repository's ``processing/handleData.py`` (every user kept under the
[1, 0] quantile band, sorted-unique dense ids, sklearn's seeded
``train_test_split`` twice: 20% held out, the holdout halved into val and
test) and of its LightGCN edge lists (duplicate pairs once, first
occurrence first).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Split:
    n_users: int
    n_items: int
    train_users: np.ndarray  # int64, rows of the train split in split order
    train_items: np.ndarray
    val_users: np.ndarray
    val_items: np.ndarray


def _seeded_split(n: int, test_size: float, seed: int):
    perm = np.random.RandomState(seed).permutation(n)
    n_test = math.ceil(test_size * n)
    return perm[n_test:], perm[:n_test]


def split_table(table: dict, seed: int, split=(0.2, 0.5)) -> Split:
    """The 8:1:1 split of a (user, item, ...) table; ``seed`` < 2**32."""
    _, users = np.unique(np.asarray(table["user"]), return_inverse=True)
    _, items = np.unique(np.asarray(table["item"]), return_inverse=True)
    train_idx, holdout = _seeded_split(users.shape[0], split[0], seed)
    val_pos, _ = _seeded_split(holdout.shape[0], split[1], seed)
    val_idx = holdout[val_pos]
    return Split(int(users.max()) + 1, int(items.max()) + 1,
                 users[train_idx].astype(np.int64), items[train_idx].astype(np.int64),
                 users[val_idx].astype(np.int64), items[val_idx].astype(np.int64))


def first_unique(users: np.ndarray, items: np.ndarray, n_items: int):
    """Each (user, item) pair once, in order of first occurrence."""
    key = users * n_items + items
    _, first = np.unique(key, return_index=True)
    first.sort()
    return users[first], items[first]


def pair_keys(users: np.ndarray, items: np.ndarray, n_items: int) -> np.ndarray:
    """Sorted unique int64 keys user * n_items + item of a set of pairs."""
    return np.unique(users * n_items + items)

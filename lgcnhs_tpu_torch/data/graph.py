"""Graph arrays, in numpy.

Port of the serving slice of ``lgcnhs_tpu/data/graph.py``: interactions stay
as flat (user, item) index arrays, and the dense U x I incidence is built once,
vectorized (reference ``utils/trans.py:13-80``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from lgcnhs_tpu_torch.data.synthetic import Columns


@dataclass(frozen=True)
class EdgeSet:
    """One split's interactions as parallel index arrays."""

    users: np.ndarray  # int32 (E,)
    items: np.ndarray  # int32 (E,)

    @property
    def n_edges(self) -> int:
        return int(self.users.shape[0])


@dataclass(frozen=True)
class InteractionGraph:
    n_users: int
    n_items: int
    all: EdgeSet
    train: EdgeSet
    val: EdgeSet
    test: EdgeSet


def edges_from_columns(table: Columns) -> EdgeSet:
    return EdgeSet(
        users=np.asarray(table["user_id"], dtype=np.int32),
        items=np.asarray(table["item_id"], dtype=np.int32),
    )


def unique_edges(es: EdgeSet) -> EdgeSet:
    """First-occurrence-ordered deduplication of (user, item) pairs.

    Load-bearing: the reference round-trips every LightGCN-side edge list
    through a dense 0/1 adjacency (``utils/graph.py:23-25``), so the GCN sees
    each interaction once even when a split keeps duplicate rows. A no-op,
    order included, on duplicate-free splits."""
    users = np.asarray(es.users)
    items = np.asarray(es.items)
    if users.size == 0:
        return EdgeSet(users.astype(np.int32), items.astype(np.int32))
    stride = np.int64(items.max()) + 1
    key = users.astype(np.int64) * stride + items.astype(np.int64)
    _, first = np.unique(key, return_index=True)
    first.sort()
    return EdgeSet(users[first].astype(np.int32), items[first].astype(np.int32))


def build_graph(splits) -> InteractionGraph:
    """From a ``RatingSplits`` to edge arrays (reference ``buildGraph``,
    ``model/LightGCN/recommend.py:23-66``)."""
    return InteractionGraph(
        n_users=splits.n_users,
        n_items=splits.n_items,
        all=edges_from_columns(splits.rating),
        train=edges_from_columns(splits.train),
        val=edges_from_columns(splits.val),
        test=edges_from_columns(splits.test),
    )


def interaction_matrix(
    n_users: int, n_items: int, *edge_sets: EdgeSet, dtype=np.float32
) -> np.ndarray:
    """Dense 0/1 user-item matrix, the union of the given splits (reference
    ``getInteractionMatrixByDataframe``, ``utils/trans.py:13-29``)."""
    A = np.zeros((n_users, n_items), dtype=dtype)
    for es in edge_sets:
        A[es.users, es.items] = 1
    return A


def pos_bool_matrix(n_users: int, n_items: int, *edge_sets: EdgeSet) -> np.ndarray:
    """Boolean positives matrix (reference uid -> [iid...] dicts,
    ``utils/trans.py:51-80``)."""
    return interaction_matrix(n_users, n_items, *edge_sets, dtype=np.bool_)

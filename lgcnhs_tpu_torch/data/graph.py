"""Graph arrays, in numpy, and the dense matrices built on the device.

Port of ``lgcnhs_tpu/data/graph.py``: interactions stay as flat (user,
item) index arrays, and the dense U x I incidence is built once, vectorized
(reference ``utils/trans.py:13-116``); the large-graph rung's bf16
incidence (``device_bf16_incidence``) and serving's A and seen
(``dense_positives``) are set on the device from the edges.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


def edge_array(*edge_sets: EdgeSet) -> np.ndarray:
    """(2, n) int32 users and items of the given splits' rows, one after
    the other: n = their rows together, 8 n bytes, written once."""
    edges = np.empty((2, sum(es.n_edges for es in edge_sets)), dtype=np.int32)
    np.concatenate([es.users for es in edge_sets], out=edges[0])
    np.concatenate([es.items for es in edge_sets], out=edges[1])
    return edges


def dense_positives(n_users: int, n_items: int, edges: torch.Tensor):
    """(A, seen) set on ``edges``' device from an ``edge_array``: the f32 0/1
    ``interaction_matrix`` and the bool ``pos_bool_matrix`` of the same
    rows, bit for bit. Each row's flat index u I + i is taken in int64 (U I
    passes 2^31 at catalogs already served) and filled with 1 in a zeroed
    A; a duplicate row fills the same 1 again. The ids are the graph's, in
    range."""
    A = torch.zeros((n_users, n_items), dtype=torch.float32, device=edges.device)
    flat = edges[0].long() * n_items + edges[1]
    A.view(-1).index_fill_(0, flat, 1.0)
    del flat
    return A, A != 0


def item_degrees(n_items: int, *edge_sets: EdgeSet) -> np.ndarray:
    """Item degree = number of interaction ROWS touching the item across the
    given splits (reference ``utils/trans.py:94-116`` counts dict-list
    entries, not unique pairs). int64."""
    deg = np.zeros(n_items, dtype=np.int64)
    for es in edge_sets:
        deg += np.bincount(es.items, minlength=n_items)
    return deg


def user_pos_counts(n_users: int, es: EdgeSet) -> np.ndarray:
    """Per-user positive ROW count of a split, the reference recall
    denominator (``metrics/accurate.py:31``)."""
    return np.bincount(es.users, minlength=n_users)


def users_present(n_users: int, es: EdgeSet) -> np.ndarray:
    """Users with >= 1 interaction in the split: the reference metrics
    average over the split's pos-dict keys only (``metrics/accurate.py:26``)."""
    return user_pos_counts(n_users, es) > 0


def _inv_sqrt_degrees(n_users: int, n_items: int, es: EdgeSet):
    """(R f64 0/1, du^-1/2, di^-1/2) in f64, 0 for zero degrees (gcn_norm's
    deg_inv_sqrt masks inf to 0)."""
    R = interaction_matrix(n_users, n_items, es, dtype=np.float64)
    du = R.sum(axis=1)
    di = R.sum(axis=0)
    with np.errstate(divide="ignore"):
        inv_su = np.where(du > 0, 1.0 / np.sqrt(du), 0.0)
        inv_si = np.where(di > 0, 1.0 / np.sqrt(di), 0.0)
    return R, inv_su, inv_si


def normalized_bipartite(n_users: int, n_items: int, es: EdgeSet, dtype=np.float32) -> np.ndarray:
    """Symmetric-normalized bipartite incidence R_hat = D_u^-1/2 R D_i^-1/2,
    dense: torch-geometric ``gcn_norm(add_self_loops=False)`` on the joint
    adjacency restricted to its user-item block (``model/LightGCN/model.py:53``).
    Computed in f64, then cast to ``dtype``."""
    R, inv_su, inv_si = _inv_sqrt_degrees(n_users, n_items, es)
    return (R * inv_su[:, None] * inv_si[None, :]).astype(dtype)


def binary_incidence_factors(n_users: int, n_items: int, es: EdgeSet):
    """Factored ``normalized_bipartite``: (R int8 0/1, du^-1/2 f32,
    di^-1/2 f32) with R_hat == diag(du^-1/2) R diag(di^-1/2). The int8
    incidence is what the dual kernel streams (``ops/cuda/propagation``)."""
    R, inv_su, inv_si = _inv_sqrt_degrees(n_users, n_items, es)
    return R.astype(np.int8), inv_su.astype(np.float32), inv_si.astype(np.float32)


def device_bf16_incidence(n_users: int, n_items: int, es: EdgeSet, device) -> torch.Tensor:
    """R_hat as a bf16 dense (U, I) incidence built on ``device``: the JAX
    ``device_bf16_incidence`` (``lgcnhs_tpu/data/graph.py:175-198``), the
    bf16-dense training rung's operand. Binary degrees (duplicate edges
    collapse, as in ``normalized_bipartite``), their inverse square roots
    taken in f64 and rounded to f32 as JAX's, each edge's value their f32
    product rounded to bf16. The values are set from the deduplicated edge
    list into a zeroed bf16 matrix: no (U, I) host array and no (U, I)
    f32/f64 intermediate anywhere."""
    ded = unique_edges(es)
    users = torch.from_numpy(ded.users.astype(np.int64)).to(device)
    items = torch.from_numpy(ded.items.astype(np.int64)).to(device)
    R = torch.zeros((n_users, n_items), dtype=torch.bfloat16, device=device)
    R[users, items] = (degree_inv_sqrt(users, n_users)[users]
                       * degree_inv_sqrt(items, n_items)[items]).to(torch.bfloat16)
    return R


def degree_inv_sqrt(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) d^-1/2 of each node, d its count in the endpoint list ``ids``:
    taken in f64 and rounded to f32, 0 for degree 0 (gcn_norm masks the
    inf)."""
    d = torch.bincount(ids, minlength=n).double()
    return torch.where(d > 0, 1.0 / torch.sqrt(d.clamp_min(1.0)), 0.0).float()

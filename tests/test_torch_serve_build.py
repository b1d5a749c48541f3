"""Serving's A and seen, set from the train+val edge array
(``data/graph.edge_array``, ``dense_positives``) inside ``serve_fused``.

- ``dense_positives`` gives the f32 ``interaction_matrix`` and the bool
  ``pos_bool_matrix`` of the same rows exactly: rows repeated inside a
  split and across train and val, an empty val split, users and items with
  no row, the last user and item.
- Two successive ``serve_fused`` calls on graphs one val row apart each
  serve their own graph: the lists that ``_serve_unfused`` gives on the
  numpy-built A and seen. Nothing is kept between calls.
- ``serve_fused.h2d_bytes`` grows by 8 n a pass, n the train+val rows.
"""
import numpy as np
import pytest
import torch

from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.models import fusion
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.ops.diffusion import general_spreading_matrix, hybrid_transfer

U, I, D = 24, 37, 8


def _es(users, items):
    return tgraph.EdgeSet(np.asarray(users, dtype=np.int32), np.asarray(items, dtype=np.int32))


def _random(seed, n, users=U, items=I):
    rng = np.random.default_rng(seed)
    return _es(rng.integers(0, users, n), rng.integers(0, items, n))


def _case(name):
    """(train, val) of a named case."""
    if name == "random":
        return _random(1, 200), _random(2, 40)
    if name == "duplicates_in_a_split":
        t = _random(3, 60)
        return _es(np.r_[t.users, t.users[:25]], np.r_[t.items, t.items[:25]]), _random(4, 10)
    if name == "duplicates_across_splits":
        t = _random(5, 80)
        return t, _es(np.r_[t.users[10:30], 0], np.r_[t.items[10:30], 0])
    if name == "empty_val":
        return _random(6, 90), _es([], [])
    if name == "empty_rows_and_columns":
        # users U/2.. and items I/2.. have no row in either split
        return _random(7, 120, U // 2, I // 2), _random(8, 20, U // 2, I // 2)
    if name == "last_user_and_item":
        return _es([U - 1, 0, U - 1], [I - 1, I - 1, 0]), _es([U - 1], [I - 1])
    raise KeyError(name)


CASES = ["random", "duplicates_in_a_split", "duplicates_across_splits", "empty_val",
         "empty_rows_and_columns", "last_user_and_item"]


def _graph(train, val):
    every = _es(np.r_[train.users, val.users], np.r_[train.items, val.items])
    return tgraph.InteractionGraph(U, I, every, train, val, _es([], []))


def _numpy_build(graph):
    return (tgraph.interaction_matrix(U, I, graph.train, graph.val),
            tgraph.pos_bool_matrix(U, I, graph.train, graph.val))


def _params(seed=3):
    gen = torch.Generator().manual_seed(seed)
    return LightGCNParams(0.1 * torch.randn(U, D, generator=gen),
                          0.1 * torch.randn(I, D, generator=gen))


def _cfg():
    return tcfg.load_config(dataset="synthetic", model="SpreadLightGCN", overrides={"k": 5})


def _served_from_numpy(graph, cfg, params):
    A, seen = map(torch.from_numpy, _numpy_build(graph))
    W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
    return fusion._serve_unfused(params.user_emb, params.item_emb, A, W, seen, cfg.k).numpy()


@pytest.mark.parametrize("case", CASES)
def test_dense_positives_equal_the_numpy_build(case):
    train, val = _case(case)
    edges = tgraph.edge_array(train, val)
    assert edges.dtype == np.int32 and edges.shape == (2, train.n_edges + val.n_edges)
    A, seen = tgraph.dense_positives(U, I, torch.from_numpy(edges))
    want_A, want_seen = _numpy_build(_graph(train, val))
    assert A.dtype == torch.float32 and seen.dtype == torch.bool
    np.testing.assert_array_equal(A.numpy(), want_A)
    np.testing.assert_array_equal(seen.numpy(), want_seen)
    assert A.numpy().tobytes() == want_A.tobytes()


@pytest.mark.parametrize("case", CASES)
def test_successive_passes_serve_their_own_graph(case):
    cfg, params = _cfg(), _params()
    train, val = _case(case)
    first = _graph(train, val)
    got_first = fusion.serve_fused(first, cfg, params)
    np.testing.assert_array_equal(got_first, _served_from_numpy(first, cfg, params))
    # one val row more or moved: (user 0, its first served item), which the
    # second pass must mask
    user, item = 0, int(got_first[0, 0])
    if val.n_edges:
        users, items = val.users.copy(), val.items.copy()
        users[-1], items[-1] = user, item
    else:
        users, items = [user], [item]
    second = _graph(train, _es(users, items))
    got_second = fusion.serve_fused(second, cfg, params)
    np.testing.assert_array_equal(got_second, _served_from_numpy(second, cfg, params))
    assert item not in got_second[user]
    np.testing.assert_array_equal(fusion.serve_fused(first, cfg, params), got_first)


@pytest.mark.parametrize("case", CASES)
def test_h2d_bytes_grow_by_eight_bytes_a_row(case):
    graph, cfg, params = _graph(*_case(case)), _cfg(), _params()
    rows = graph.train.n_edges + graph.val.n_edges
    for _ in range(2):
        before = (fusion.serve_fused.passes, fusion.serve_fused.h2d_bytes)
        fusion.serve_fused(graph, cfg, params)
        assert (fusion.serve_fused.passes, fusion.serve_fused.h2d_bytes) == (
            before[0] + 1, before[1] + 8 * rows)

"""Port data path vs the JAX package: synthesis, splits and graph arrays.

Same seed in, identical tables out: the synthetic frame row for row, the
train/val/test splits row for row (membership and order), and the edge
arrays, dedupe, interaction matrix and seen mask bitwise.
"""
import numpy as np
import pytest

from lgcnhs_tpu import config as jcfg
from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.data.ratings import prepare_ratings as j_prepare
from lgcnhs_tpu.data.synthetic import synthesize_movielens_like as j_synth
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.data.datasets import load_dataset as t_load
from lgcnhs_tpu_torch.data.ratings import COLUMNS, prepare_ratings as t_prepare
from lgcnhs_tpu_torch.data.synthetic import synthesize_movielens_like as t_synth

SCALES = [(120, 200, 3000, 42), (300, 450, 9000, 7)]
QUANTILES = [(1.0, 0.0), (0.9, 0.15)]


@pytest.mark.parametrize("n_users,n_items,n_inter,seed", SCALES)
def test_synthetic_frame_matches_row_for_row(n_users, n_items, n_inter, seed):
    df = j_synth(n_users, n_items, n_inter, seed=seed)
    cols = t_synth(n_users, n_items, n_inter, seed=seed)
    assert list(cols) == list(df.columns)
    for name in df.columns:
        np.testing.assert_array_equal(cols[name], df[name].to_numpy())


def _configs(quantile):
    overrides = {
        "preprocessing.quantile_start": quantile[0],
        "preprocessing.quantile_end": quantile[1],
    }
    return (
        jcfg.load_config(dataset="synthetic", overrides=overrides),
        tcfg.load_config(dataset="synthetic", overrides=overrides),
    )


@pytest.mark.parametrize("quantile", QUANTILES)
@pytest.mark.parametrize("n_users,n_items,n_inter,seed", SCALES)
def test_splits_match_row_for_row(n_users, n_items, n_inter, seed, quantile):
    jc, tc = _configs(quantile)
    df = j_synth(n_users, n_items, n_inter, seed=seed)
    want = j_prepare(df, jc, save_path=None)
    got = t_prepare(t_synth(n_users, n_items, n_inter, seed=seed), tc)
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    assert got.uid_mapping == want.uid_mapping
    assert got.iid_mapping == want.iid_mapping
    for split in ("rating", "train", "val", "test"):
        w, g = getattr(want, split), getattr(got, split)
        for name in COLUMNS:
            np.testing.assert_array_equal(g[name], w[name].to_numpy(), err_msg=f"{split}.{name}")


def test_graph_arrays_match_bitwise():
    jc, tc = _configs((1.0, 0.0))
    want = jgraph.build_graph(j_prepare(j_synth(250, 380, 7000, seed=3), jc, save_path=None))
    got = tgraph.build_graph(t_prepare(t_synth(250, 380, 7000, seed=3), tc))
    assert (got.n_users, got.n_items) == (want.n_users, want.n_items)
    for split in ("all", "train", "val", "test"):
        w, g = getattr(want, split), getattr(got, split)
        assert g.users.dtype == w.users.dtype and g.items.dtype == w.items.dtype
        np.testing.assert_array_equal(g.users, w.users)
        np.testing.assert_array_equal(g.items, w.items)
    U, I = want.n_users, want.n_items
    wa = jgraph.interaction_matrix(U, I, want.train, want.val)
    ga = tgraph.interaction_matrix(U, I, got.train, got.val)
    assert ga.dtype == wa.dtype and np.array_equal(ga, wa)
    ws = jgraph.pos_bool_matrix(U, I, want.train, want.val)
    gs = tgraph.pos_bool_matrix(U, I, got.train, got.val)
    assert gs.dtype == ws.dtype and np.array_equal(gs, ws)


@pytest.mark.parametrize("n_dup", [0, 1, 40])
def test_unique_edges_matches(n_dup):
    rng = np.random.default_rng(n_dup)
    users = rng.integers(0, 30, 200).astype(np.int32)
    items = rng.integers(0, 50, 200).astype(np.int32)
    # duplicated (user, item) rows, scattered: the dedupe keeps first ones
    pick = rng.integers(0, 200, n_dup)
    users = np.insert(users, rng.integers(0, 200, n_dup), users[pick])
    items = np.insert(items, rng.integers(0, 200, n_dup), items[pick])
    want = jgraph.unique_edges(jgraph.EdgeSet(users, items))
    got = tgraph.unique_edges(tgraph.EdgeSet(users, items))
    np.testing.assert_array_equal(got.users, want.users)
    np.testing.assert_array_equal(got.items, want.items)
    assert got.n_edges == want.n_edges


def test_load_dataset_synthesizes_named_dataset_at_configured_scale(tmp_path):
    from lgcnhs_tpu.data.datasets import load_dataset as j_load

    over = {"synthetic_users": 90, "synthetic_items": 140, "synthetic_interactions": 2500}
    jc = jcfg.load_config(dataset="movielens1m", workdir=str(tmp_path / "j"), overrides=over)
    tc = tcfg.load_config(dataset="movielens1m", workdir=str(tmp_path / "t"), overrides=over)
    want, wuf, wif = j_load(jc)
    got, guf, gif = t_load(tc)
    np.testing.assert_array_equal(guf, wuf)
    np.testing.assert_array_equal(gif, wif)
    for split in ("train", "val", "test"):
        np.testing.assert_array_equal(
            getattr(got, split)["item_id"], getattr(want, split)["item_id"].to_numpy()
        )


def test_movielens1m_preset_scale():
    cfg = tcfg.load_config(dataset="movielens1m", env="prod")
    assert (cfg.synthetic_users, cfg.synthetic_items, cfg.synthetic_interactions) == (
        6040, 3706, 1_000_209)
    assert cfg.k == 100

"""LightGCN[Opti] serving through ``models/recommenders.recommend_gcn`` and
the benchmark's ``ml1m-retrieve-k1000`` cell, on the CPU.

- ``recommend_gcn`` (the edge array uploaded, seen set on the device by
  ``data/graph.dense_seen``) gives the ids of the host-mask chain it
  replaced (``masked_topk`` over a numpy ``pos_bool_matrix``) and of the
  JAX package's ``recommend_gcn`` and ``retrieve_topk``: at k < I, at
  k = I, and for a user with fewer unseen items than k, whose tail is its
  seen items in id order (the -1024 sentinel, ties to the lowest id). The
  tables are dyadic, so the scores are exact and ties many.
- The chunked branch past the dense budget gives the same ids.
- ``cli/retrieve`` for LightGCNOpti writes the host-mask chain's matrix.
- A pass opens ``retrieve.pass`` holding build, upload, build, rank and
  download in that order (the chunked branch: build, rank, download), and
  counts one pass and 8 n bytes, n the train+val rows.
- ``portbench/reference/retrieve.py`` against a numpy float64 ranking.
- The cell end to end through ``portbench/tests/tiny.py``: judged correct,
  and each fault planted in the timed path (a seen item served, the lists
  shifted by one, bf16 tables) judged wrong.
- ``fused_topk_roofline`` and ``retrieve.build_share`` on hand-made traces,
  and the counts at the cell's shapes (6,040 x 3,706 x 64, k=1000).
"""
import dataclasses
import os
import sys
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_checks import dyadic  # noqa: E402

import lgcnhs_tpu.models.recommenders as jrec
from lgcnhs_tpu.config import load_config as j_load_config
from lgcnhs_tpu.data import graph as jgraph
from lgcnhs_tpu.models.lightgcn import LightGCNParams as JParams
from lgcnhs_tpu.ops.topk import retrieve_topk as j_retrieve_topk
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import retrieve as t_retrieve
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.models import lightgcn as tlgcn
from lgcnhs_tpu_torch.models import recommenders as trec
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.ops.topk import masked_topk
from lgcnhs_tpu_torch.train import trainer as ttrainer
from portbench import harness
from portbench.reference import retrieve as ref_retrieve
from portbench.reference import serve as ref_serve
from portbench.reference.data import Split
from portbench.tests import tiny
from portbench.trace import TraceView

U, I, D = 40, 64, 8
PEAKS = harness.peaks()
# the cell: 6,040 users, 3,706 items, 905,236 train+val pairs, D 64, k 1000
CELL = {"U": 6040, "I": 3706, "nnz": 905236, "D": 64, "L": 3, "k": 1000, "batch": 1024}
PASS_CHILDREN = ["retrieve.build", "retrieve.upload", "retrieve.build", "retrieve.rank",
                 "retrieve.download"]


@pytest.fixture(autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _graph(seed=5, full_user=True):
    """A graph whose val rows repeat some train rows; user 0 has seen all but
    3 items (``full_user``)."""
    rng = np.random.default_rng(seed)
    tu, ti = rng.integers(0, U, 500), rng.integers(0, I, 500)
    if full_user:
        tu, ti = np.r_[np.zeros(I - 3, np.int64), tu], np.r_[np.arange(3, I), ti]
    vu, vi = np.r_[tu[5:25], rng.integers(0, U, 40)], np.r_[ti[5:25], rng.integers(0, I, 40)]
    tu, ti, vu, vi = (a.astype(np.int32) for a in (tu, ti, vu, vi))
    return tgraph.InteractionGraph(U, I, tgraph.EdgeSet(np.r_[tu, vu], np.r_[ti, vi]),
                                   tgraph.EdgeSet(tu, ti), tgraph.EdgeSet(vu, vi),
                                   tgraph.EdgeSet(tu[:0], ti[:0]))


def _params(seed=3):
    rng = np.random.default_rng(seed)
    return LightGCNParams(torch.from_numpy(dyadic(rng, (U, D))),
                          torch.from_numpy(dyadic(rng, (I, D))))


def _cfg(k):
    return tcfg.load_config(dataset="synthetic", model="LightGCNOpti", overrides={"k": k})


def _host_chain(graph, params, k):
    """The path ``recommend_gcn`` and ``cli/retrieve`` took before: a numpy
    seen, uploaded, and the plain masked top-k."""
    seen = torch.from_numpy(tgraph.pos_bool_matrix(graph.n_users, graph.n_items,
                                                   graph.train, graph.val))
    return masked_topk(params.user_emb @ params.item_emb.T, seen, k).numpy()


@pytest.mark.parametrize("k", [7, I, 5], ids=["k_below_I", "k_is_I", "short_user"])
def test_recommend_gcn_matches_the_host_chain_and_jax(k):
    graph, params = _graph(full_user=k != 7), _params()
    rec = trec.recommend_gcn(graph, _cfg(k), params)
    assert rec.shape == (U, k) and rec.dtype == np.int32
    np.testing.assert_array_equal(rec, _host_chain(graph, params, k))

    j_graph = jgraph.InteractionGraph(U, I, *(jgraph.EdgeSet(e.users, e.items) for e in
                                              (graph.all, graph.train, graph.val, graph.test)))
    ue, ie = (t.numpy() for t in params)
    j_cfg = j_load_config(dataset="synthetic", model="LightGCNOpti", overrides={"k": k})
    np.testing.assert_array_equal(
        rec, np.asarray(jrec.recommend_gcn(j_graph, j_cfg, JParams(jnp.asarray(ue),
                                                                   jnp.asarray(ie)))))
    seen = jgraph.pos_bool_matrix(U, I, j_graph.train, j_graph.val)
    np.testing.assert_array_equal(
        rec, np.asarray(j_retrieve_topk(jnp.asarray(ue), jnp.asarray(ie), jnp.asarray(seen), k)))

    seen_t = tgraph.pos_bool_matrix(U, I, graph.train, graph.val)
    if k == 5:  # user 0: its 3 unseen items, then its seen items 3 and 4 (ids in order)
        assert sorted(rec[0, :3]) == [0, 1, 2] and list(rec[0, 3:]) == [3, 4]
        assert not seen_t[0, rec[0, :3]].any()
    else:
        short = (~seen_t).sum(1) < k
        assert not seen_t[np.arange(U)[~short, None], rec[~short]].any()


def test_chunked_branch_gives_the_same_ids(monkeypatch):
    graph, params, cfg = _graph(), _params(), _cfg(9)
    want = trec.recommend_gcn(graph, cfg, params)
    calls = []
    chunked = trec.chunked_masked_topk
    monkeypatch.setattr(ttrainer, "DENSIFY_BUDGET_BYTES", 1.0)
    monkeypatch.setattr(trec, "chunked_masked_topk", lambda *a: calls.append(a[0].shape)
                        or chunked(*a, chunk_bytes=4 * 8 * I))
    bytes0 = trec.recommend_gcn.h2d_bytes
    got, events = _profiled(lambda: trec.recommend_gcn(graph, cfg, params))
    assert calls == [(U, D)]
    np.testing.assert_array_equal(got, want)
    assert _children(events) == ["retrieve.build", "retrieve.rank", "retrieve.download"]
    assert trec.recommend_gcn.h2d_bytes == bytes0  # the chunks upload their own masks


def test_cli_retrieve_writes_the_host_chain_matrix(tmp_path):
    size = ["--dataset", "synthetic", "--env", "dev", "--users", "90", "--items", "120",
            "--interactions", "2500", "--k", "10"]
    cfg = tcfg.load_config(dataset="synthetic", model="LightGCNOpti", workdir=str(tmp_path),
                           overrides={"k": 10, "synthetic_users": 90, "synthetic_items": 120,
                                      "synthetic_interactions": 2500})
    splits, uf, itf = load_dataset(cfg)
    graph = tgraph.build_graph(splits)
    params = tlgcn.init_lightgcn_opti(torch.Generator().manual_seed(0), uf, itf, 16)
    os.makedirs(cfg.model_path, exist_ok=True)
    ttrainer.save_checkpoint(trec.checkpoint_path(cfg), params)
    passes = trec.recommend_gcn.passes
    got = t_retrieve.main(["--device", "cpu", "--model", "LightGCNOpti",
                           "--workdir", str(tmp_path), *size])
    assert trec.recommend_gcn.passes == passes + 1
    saved = np.load(os.path.join(cfg.recommend_path, "retrieval_LightGCNOpti_10.npy"))
    np.testing.assert_array_equal(saved, got)
    np.testing.assert_array_equal(got, _host_chain(graph, params, 10))


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [ev for ev in prof.events() if ev.name.startswith("retrieve.")]


def _children(events):
    """The spans inside the one ``retrieve.pass``, in the order they opened."""
    (outer,) = [ev for ev in events if ev.name == "retrieve.pass"]
    inner = [ev for ev in events if ev.name != "retrieve.pass"]
    assert all(ev.cpu_parent is not None and ev.cpu_parent.name == "retrieve.pass"
               for ev in inner)
    assert all(outer.time_range.start <= ev.time_range.start
               and ev.time_range.end <= outer.time_range.end for ev in inner)
    return [ev.name for ev in sorted(inner, key=lambda ev: ev.time_range.start)]


def test_spans_open_in_order_and_the_counters_count():
    graph, params, cfg = _graph(), _params(), _cfg(6)
    plain = trec.recommend_gcn(graph, cfg, params)
    before = (trec.recommend_gcn.passes, trec.recommend_gcn.h2d_bytes)
    rec, events = _profiled(lambda: trec.recommend_gcn(graph, cfg, params))
    np.testing.assert_array_equal(rec, plain)
    rows = graph.train.n_edges + graph.val.n_edges
    assert (trec.recommend_gcn.passes, trec.recommend_gcn.h2d_bytes) == \
        (before[0] + 1, before[1] + 8 * rows)
    assert _children(events) == PASS_CHILDREN


def test_dense_seen_is_the_host_matrix():
    graph = _graph()
    edges = torch.from_numpy(tgraph.edge_array(graph.train, graph.val))
    seen = tgraph.dense_seen(U, I, edges)
    assert seen.dtype == torch.bool
    np.testing.assert_array_equal(seen.numpy(),
                                  tgraph.pos_bool_matrix(U, I, graph.train, graph.val))
    np.testing.assert_array_equal(seen.numpy(), tgraph.dense_positives(U, I, edges)[1].numpy())


@pytest.mark.parametrize("precision", ["float64", "bfloat16"])
def test_reference_scores_against_numpy(precision):
    rng = np.random.default_rng(11)
    tu, ti = rng.integers(0, U, 300), rng.integers(0, I, 300)
    vu, vi = np.r_[tu[:10], rng.integers(0, U, 30)], np.r_[ti[:10], rng.integers(0, I, 30)]
    split = Split(U, I, tu, ti, vu, vi)
    ue = torch.from_numpy(rng.standard_normal((U, D)).astype(np.float32))
    ie = torch.from_numpy(rng.standard_normal((I, D)).astype(np.float32))
    users = np.array([31, 2, 17, 0])
    got = ref_retrieve.layer0_scores(split, ue, ie, users, precision)
    want = ue.double().numpy()[users] @ ie.double().numpy().T
    seen = np.zeros((U, I), bool)
    seen[np.r_[tu, vu], np.r_[ti, vi]] = True
    assert np.isneginf(got.numpy()[seen[users]]).all()
    free = ~seen[users]
    if precision == "float64":
        np.testing.assert_array_equal(got.numpy()[free], want[free])
        order = np.argsort(-np.where(seen[users], -np.inf, want), axis=1, kind="stable")[:, :9]
        np.testing.assert_array_equal(ref_serve.top_lists(got, 9), order)
    else:
        gap = np.abs(got.numpy()[free] - want[free]).max()
        assert 0 < gap < 0.1 * np.abs(want).max()


def _tiny_line(monkeypatch, fault=None):
    """The tiny cell's untraced line, ``fault`` wrapping ``recommend_gcn``
    where the driver looks it up, so the window's passes carry it."""
    if fault is not None:
        real = trec.recommend_gcn
        monkeypatch.setattr(trec, "recommend_gcn", lambda g, c, p: fault(real, g, c, p))
    return tiny.run("ml1m-retrieve-k1000", seconds=0.5)


def test_the_cell_end_to_end_is_correct(monkeypatch):
    line = _tiny_line(monkeypatch)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"serve_users_per_s", "serve_pass_p95_ms", "peak_mem_gib",
                                    "setup_s"}
    assert line["attempted"] > 0 and line["checks"]["score_gap"]["value"] <= 1e-6


def _seen_served(real, g, c, p):
    rec = real(g, c, p)
    seen = tgraph.pos_bool_matrix(g.n_users, g.n_items, g.train, g.val)
    has = seen.any(1)
    rec[has, -1] = seen[has].argmax(1)  # each user's lowest seen id in the last slot
    return rec


def _shifted(real, g, c, p):
    return real(g, dataclasses.replace(c, k=c.k + 1), p)[:, 1:]


def _bf16_tables(real, g, c, p):
    return real(g, c, LightGCNParams(*(t.bfloat16().float() for t in p)))


@pytest.mark.parametrize("fault", [_seen_served, _shifted, _bf16_tables],
                         ids=["seen_served", "shifted_by_one", "bf16_tables"])
def test_faults_in_the_timed_path_are_caught(monkeypatch, fault):
    line = _tiny_line(monkeypatch, fault)
    assert line["correct"] is False
    assert line["checks"]["score_gap"]["value"] > 1e-4
    if fault is _seen_served:
        assert line["checks"]["score_gap"]["value"] == float("inf")


def test_traced_tiny_cell_reads_the_build_share():
    line = tiny.run("ml1m-retrieve-k1000", seconds=0.5, trace=True)
    assert line["correct"] is True, line["checks"]
    # no card: the roofline, host share and idle read nothing; the spans do
    assert set(line["metrics"]) == {"retrieve.build_share"}
    assert 0 < line["metrics"]["retrieve.build_share"]["value"] < 100


def _ctx(view, counts=None, shapes=CELL):
    return harness.Context(view, {}, shapes, PEAKS, counts or {})


def test_fused_topk_count_at_the_cell():
    m = harness.load_metric("fused_topk_roofline")
    flops, nbytes = m.work(CELL)
    assert flops == 2 * 6040 * 3706 * 64 == 2_865_182_720
    # tables (6,040 + 3,706) 64 4 = 2,494,976; bitmap 6040*3706/8 = 2,798,030 < edge list
    # 7,241,888; lists 6040 * 1000 * 8 = 48,320,000
    assert nbytes == 2_494_976 + 2_798_030 + 48_320_000 == 53_613_006
    assert m.F32_FLOPS_PER_S == 67e12
    assert m.least_seconds(CELL, PEAKS) == pytest.approx(2_865_182_720 / 67e12)  # FLOP-bound
    assert m.least_seconds(CELL, PEAKS) == pytest.approx(42.76e-6, rel=1e-3)
    assert nbytes / PEAKS["hbm_bytes_per_s"] == pytest.approx(16.00e-6, rel=1e-3)


def test_fused_topk_roofline_reads_the_launches_and_refuses_a_mismatch():
    ms = 1_000_000
    ops = [("void (anonymous namespace)::fused_topk_kernel<0>(float const*, ...)",
            i * ms, i * ms + 400_000) for i in range(3)]
    ops += [("void lgcnhs::part_lists_merge_kernel<false>(int*, ...)",
             i * ms + 400_000, i * ms + 500_000) for i in range(3)]
    ops += [("void at::native::vectorized_elementwise_kernel<4>(...)", 8 * ms, 9 * ms)]
    view = TraceView((0, 10 * ms), ops)
    m = harness.load_metric("fused_topk_roofline")
    per_launch = 3 * 500_000 / 1e9 / 3
    got = m.read(_ctx(view, {"fused_topk_retrieval": 3}))
    assert got == pytest.approx(100 * (2_865_182_720 / 67e12) / per_launch)
    assert m.read(_ctx(view, {"fused_topk_retrieval": 2})) is None
    assert m.read(_ctx(TraceView((0, 10 * ms)), {"fused_topk_retrieval": 0})) is None
    assert m.read(_ctx(view)) is None  # a program without the counter


def test_build_share_over_the_passes_and_none_without_spans():
    host = [("retrieve.pass", 0, 1000), ("retrieve.build", 0, 100), ("retrieve.upload", 100, 150),
            ("retrieve.build", 150, 200), ("retrieve.rank", 200, 900),
            ("retrieve.pass", 1000, 3000), ("retrieve.build", 1000, 1200),
            ("retrieve.upload", 1200, 1300), ("retrieve.pass", 2900, 4000)]  # cut by the window
    view = TraceView((0, 3500), [("k", 300, 800)], host)
    m = harness.load_metric("retrieve.build_share")
    assert m.read(_ctx(view)) == pytest.approx(100 * (150 + 50 + 300) / 3000)
    serve_spans = [("serve.pass", 0, 1000), ("serve.build", 0, 500)]
    assert m.read(_ctx(TraceView((0, 3500), [("k", 300, 800)], serve_spans))) is None


def test_the_cell_reports_its_metrics():
    bench = harness.benchmark_spec()
    e2e = {x["name"] for x in harness.end_to_end_of(bench, "ml1m-retrieve-k1000")}
    assert e2e == {"serve_users_per_s", "serve_pass_p95_ms", "peak_mem_gib", "setup_s"}
    layers = Counter(x["layer"] for x in harness.per_layer_of(bench, "ml1m-retrieve-k1000"))
    assert {x["name"] for x in harness.per_layer_of(bench, "ml1m-retrieve-k1000")} == {
        "serve.host_share", "device_idle.serve", "fused_topk_roofline", "retrieve.build_share"}
    assert layers == {"serving": 2, "device": 1, "kernels": 1}
    config = harness.config_file("ml1m-lightgcnopti")
    ml1m = harness.config_file("ml1m")
    assert (config["model"], config["k"]) == ("LightGCNOpti", 1000)
    assert {key for key in ml1m if config[key] != ml1m[key]} == {
        "name", "source", "model", "k", "assumed"}

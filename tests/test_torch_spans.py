"""The port's spans and counters (``runtime/logging.span``,
``ops/cuda/launches.count``) on the CPU.

- With no profiler session, a span never enters ``record_function``.
- Under a ``torch.profiler`` session, ``serve_fused`` (the plain route)
  records one ``serve.pass`` holding two ``serve.build`` (the edge array
  on the host, A and seen on the device), one ``serve.upload`` and one
  each of ``serve.transfer_matrix``, ``serve.rank`` and
  ``serve.download``; ``serve_fused.passes`` goes up by one and
  ``serve_fused.h2d_bytes`` by 8 n, n the train+val rows, with or without
  a session.
- ``train_lightgcn`` records one ``train.setup``, a ``train.replay`` a
  chunk of the scan (the step's loop on the CPU), a ``train.step`` an
  eager epoch, and one
  ``train.val_loss``, ``train.evaluate`` and ``train.record`` an eval row,
  and trains the same model as without a session; the log call of an
  eval row, whose handlers are the caller's, is outside ``train.record``.
- The spans are ranges of a ``--profile`` trace (``profile_trace``).
- ``count`` under a capture tally counts at each replay.
- The benchmark still reads the program: the tiny training cell is
  ``correct`` (the frame reads of ``_record_eval`` and ``train_lightgcn``
  still work), and the tiny traced serving line reports the serving span
  metrics, ``serve.h2d_mb_per_pass`` at 8 n / 1e6.
"""
import json
import logging
from collections import Counter

import numpy as np
import pytest
import torch

from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.data import graph as tgraph
from lgcnhs_tpu_torch.models.fusion import serve_fused
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.ops.cuda import launches
from lgcnhs_tpu_torch.runtime.logging import profile_trace, span, stage_timer
from lgcnhs_tpu_torch.train import trainer as ttrainer

U, I, D = 30, 45, 8
SERVE_CHILDREN = {"serve.build": 2, "serve.upload": 1, "serve.transfer_matrix": 1,
                  "serve.rank": 1, "serve.download": 1}


@pytest.fixture(autouse=True)
def one_thread():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def _graph(seed=5):
    rng = np.random.default_rng(seed)
    tu, ti = rng.integers(0, U, 400).astype(np.int32), rng.integers(0, I, 400).astype(np.int32)
    vu, vi = rng.integers(0, U, 60).astype(np.int32), rng.integers(0, I, 60).astype(np.int32)
    return tgraph.InteractionGraph(U, I, tgraph.EdgeSet(np.r_[tu, vu], np.r_[ti, vi]),
                                   tgraph.EdgeSet(tu, ti), tgraph.EdgeSet(vu, vi),
                                   tgraph.EdgeSet(tu[:0], ti[:0]))


def _params(seed=3):
    gen = torch.Generator().manual_seed(seed)
    return LightGCNParams(0.1 * torch.randn(U, D, generator=gen),
                          0.1 * torch.randn(I, D, generator=gen))


def _serve_cfg():
    return tcfg.load_config(dataset="synthetic", model="SpreadLightGCN", overrides={"k": 5})


def _train_cfg(scan_chunk):
    return tcfg.load_config(dataset="synthetic", model="LightGCN", overrides={
        "hparams.epochs": 10, "hparams.epoch_per_eval": 4, "hparams.batch_size": 32,
        "hparams.embedding_dim": D, "k": 5, "compute.dtype": "float32",
        "compute.scan_chunk": scan_chunk})


def _profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [ev for ev in prof.events() if ev.name.startswith(("serve.", "train."))]


def _parent(ev):
    """The nearest enclosing span of ``ev`` (aten operators skipped)."""
    p = ev.cpu_parent
    while p is not None and not p.name.startswith(("serve.", "train.")):
        p = p.cpu_parent
    return None if p is None else p.name


def test_span_without_a_profiler_never_enters_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler session")

    # the name ``span`` looks up (torch's own optimizers enter
    # ``torch.autograd.profiler.record_function`` at every step)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with span("serve.pass"), span("serve.build"):
        pass
    with stage_timer("a stage", span_name="train.setup"):
        pass
    serve_fused(_graph(), _serve_cfg(), _params())
    ttrainer.train_lightgcn(_graph(), _train_cfg(0), save_artifacts=False, device="cpu")


def test_span_records_nested_ranges_only_while_a_session_records():
    outer_open = span("train.setup")
    outer_open.__enter__()  # opened before the session: recorded nowhere

    def body():
        with span("serve.pass"), span("serve.build"):
            torch.ones(4).sum()
        with stage_timer("a stage", span_name="serve.rank"):
            torch.ones(4).sum()

    _, events = _profiled(body)
    outer_open.__exit__(None, None, None)
    assert sorted(ev.name for ev in events) == ["serve.build", "serve.pass", "serve.rank"]
    assert {ev.name: _parent(ev) for ev in events} == {
        "serve.pass": None, "serve.build": "serve.pass", "serve.rank": None}


def test_serve_fused_spans_and_counters():
    graph, cfg, params = _graph(), _serve_cfg(), _params()
    plain = serve_fused(graph, cfg, params)
    before = (serve_fused.passes, serve_fused.h2d_bytes)
    rec, events = _profiled(lambda: serve_fused(graph, cfg, params))
    np.testing.assert_array_equal(rec, plain)
    rows = graph.train.n_edges + graph.val.n_edges
    assert (serve_fused.passes, serve_fused.h2d_bytes) == (before[0] + 1, before[1] + 8 * rows)
    passes = [ev for ev in events if ev.name == "serve.pass"]
    assert len(passes) == 1
    children = Counter(ev.name for ev in events if ev.name != "serve.pass")
    assert children == SERVE_CHILDREN
    assert all(_parent(ev) == "serve.pass" for ev in events if ev.name != "serve.pass")
    (outer,) = passes
    assert all(outer.time_range.start <= ev.time_range.start
               and ev.time_range.end <= outer.time_range.end for ev in events)


def test_spans_are_ranges_of_a_profile_trace(tmp_path):
    with profile_trace(str(tmp_path), "cpu"):
        serve_fused(_graph(), _serve_cfg(), _params())
    (path,) = tmp_path.glob("*.pt.trace.json")
    with open(path) as f:
        names = Counter(e.get("name") for e in json.load(f)["traceEvents"])
    assert {name: names[name] for name in SERVE_CHILDREN} == SERVE_CHILDREN
    assert names["serve.pass"] == 1


def _calls(epochs, per_eval, scan_chunk):
    """(scan calls, eager steps) of ``_train_epochs``: a scan call a
    sub-chunk of each interval of more than one epoch up to an eval
    boundary, an eager step an interval of one epoch."""
    calls, steps, epoch = 0, 0, 0
    while epoch < epochs:
        last = epoch
        while last < epochs - 1 and last % per_eval:
            last += 1
        n = last + 1 - epoch
        if n > 1:
            calls += -(-n // (scan_chunk or n))
        else:
            steps += 1
        epoch = last + 1
    return calls, steps


@pytest.mark.parametrize("scan_chunk", [0, 3])
def test_train_lightgcn_spans(scan_chunk):
    graph, cfg = _graph(), _train_cfg(scan_chunk)
    plain = ttrainer.train_lightgcn(graph, cfg, save_artifacts=False, device="cpu")
    result, events = _profiled(
        lambda: ttrainer.train_lightgcn(graph, cfg, save_artifacts=False, device="cpu"))
    assert result.history == plain.history
    for a, b in zip(result.params, plain.params):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    rows = len(plain.history["iters"])  # evals at epochs 0, 4, 8
    assert rows == 3
    calls, steps = _calls(10, 4, scan_chunk)
    assert (calls, steps) == ((2 if scan_chunk == 0 else 4), 2)  # epochs 0 and 9 alone
    assert Counter(ev.name for ev in events) == {
        "train.setup": 1, "train.replay": calls, "train.step": steps,
        "train.val_loss": rows, "train.evaluate": rows, "train.record": rows}
    assert all(_parent(ev) is None for ev in events)


def test_train_record_leaves_out_the_log_handlers():
    """A handler on the ``[Iteration e/E]`` record (``portbench/drivers/
    train.py`` reads the program there) runs inside no span of the program."""

    class Handler(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("[Iteration"):
                with torch.profiler.record_function("a handler"):
                    torch.ones(3).sum()

    log = logging.getLogger("lgcnhs")
    handler = Handler()
    log.addHandler(handler)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            ttrainer.train_lightgcn(_graph(), _train_cfg(0), save_artifacts=False, device="cpu")
    finally:
        log.removeHandler(handler)
    handled = [ev for ev in prof.events() if ev.name == "a handler"]
    records = [ev for ev in prof.events() if ev.name == "train.record"]
    assert len(handled) == len(records) == 3
    assert [_parent(ev) for ev in handled] == [None] * 3


def test_count_under_a_capture_tally_counts_at_each_replay(monkeypatch):
    def fn():
        pass

    fn.h2d_bytes = 0
    launches.count(fn, "h2d_bytes", 10)
    assert fn.h2d_bytes == 10
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    with launches.capture_tally() as tally:
        launches.count(fn, "h2d_bytes", 7)
        launches.count_launch(fn, "h2d_bytes")
    assert fn.h2d_bytes == 10 and tally == {(fn, "h2d_bytes"): 8}
    launches.add_replays(tally, 3)
    assert fn.h2d_bytes == 34


def test_the_benchmark_still_reads_the_program(monkeypatch):
    from portbench.drivers import serve as serve_driver
    from portbench.tests import tiny

    # a window of 4 s holds an interval that ends in an eval row however
    # slow the host: at 1.5 s a loaded host can close it at the first job's
    # return, which judges no loss and no row
    line = tiny.run("ml1m-train", seconds=4.0)
    assert line["correct"] is True, line["checks"]

    graphs = []
    program_graph = serve_driver.problem.program_graph
    monkeypatch.setattr(serve_driver.problem, "program_graph",
                        lambda *a: graphs.append(program_graph(*a)) or graphs[-1])
    line = tiny.run("ml1m-serve", trace=True)
    assert line["correct"] is True, line["checks"]
    metrics = line["metrics"]
    assert {"serve.build_share", "serve.upload_share", "serve.h2d_mb_per_pass"} <= set(metrics)
    ((_, graph),) = graphs
    rows = graph.train.n_edges + graph.val.n_edges
    assert metrics["serve.h2d_mb_per_pass"]["value"] == pytest.approx(8 * rows / 1e6, rel=1e-12)
    for name in ("serve.build_share", "serve.upload_share"):
        assert 0 < metrics[name]["value"] < 100

"""The benchmark's readers of the port's spans and counters
(``portbench/metrics/{train.launch_idle_share, train.eval_idle_share,
serve.build_share, serve.upload_share, serve.h2d_mb_per_pass}.py``,
``portbench/spans.py``) on hand-made ``portbench.trace.TraceView``s: nested
spans, the card's idle time split between a replay and the boundary spans,
a window without spans (None), and the counters' ratio, which a program
without the counters leaves unread."""
import importlib

import pytest

from portbench import harness, spans
from portbench.trace import TraceView

MS = 1_000_000  # ns
SPAN_METRICS = ("train.launch_idle_share", "train.eval_idle_share", "serve.build_share",
                "serve.upload_share")


def _read(name, view, counts=None):
    ctx = harness.Context(view, {}, {}, {}, counts or {})
    return harness.load_metric(name).read(ctx)


def _serve_view():
    """Two whole passes in a 0-100 ms window, and a third cut by its end.
    Pass 1 (0-40): builds 0-10 and 15-20, uploads 10-14 and 20-24 (an
    aten op nested in one), W, rank and download after. Pass 2 (50-90):
    builds 50-60 and 65-70, one upload 60-64. Pass 3 (92-110) ends past
    the window."""
    host = [("serve.pass", 0, 40 * MS), ("serve.build", 0, 10 * MS),
            ("serve.upload", 10 * MS, 14 * MS), ("aten::to", 11 * MS, 13 * MS),
            ("serve.build", 15 * MS, 20 * MS), ("serve.upload", 20 * MS, 24 * MS),
            ("serve.transfer_matrix", 24 * MS, 30 * MS), ("serve.rank", 30 * MS, 31 * MS),
            ("serve.download", 31 * MS, 40 * MS),
            ("serve.pass", 50 * MS, 90 * MS), ("serve.build", 50 * MS, 60 * MS),
            ("serve.upload", 60 * MS, 64 * MS), ("serve.build", 65 * MS, 70 * MS),
            ("serve.pass", 92 * MS, 110 * MS), ("serve.build", 92 * MS, 100 * MS)]
    device = [("Memcpy HtoD", 10 * MS, 14 * MS), ("sgemm", 24 * MS, 30 * MS),
              ("fused_serve_kernel", 31 * MS, 33 * MS)]
    return TraceView((0, 100 * MS), device, host)


def test_serve_shares_over_nested_spans():
    view = _serve_view()
    # passes 1 and 2 (80 ms); builds 15 + 15 ms inside them, uploads 8 + 4 ms
    assert _read("serve.build_share", view) == pytest.approx(100 * 30 / 80)
    assert _read("serve.upload_share", view) == pytest.approx(100 * 12 / 80)


def test_a_build_nested_in_a_build_counts_once():
    host = [("serve.pass", 0, 10 * MS), ("serve.build", 0, 6 * MS),
            ("serve.build", 1 * MS, 3 * MS)]
    view = TraceView((0, 20 * MS), [("k", 12 * MS, 13 * MS)], host)
    assert _read("serve.build_share", view) == pytest.approx(60.0)
    assert _read("serve.upload_share", view) == 0.0  # a pass without an upload


def _train_view():
    """A 0-100 ms window: replay spans 0-30 and 60-75, with the card idle
    0-20 (the graph's launch) and 60-65; boundary spans val loss 30-40,
    evaluate 40-50 (busy 42-48), record 50-58 (the host waiting at its
    first read); the card busy 20-30, 42-48, 65-95, idle elsewhere."""
    host = [("train.replay", 0, 30 * MS), ("cudaGraphLaunch", 1 * MS, 19 * MS),
            ("train.val_loss", 30 * MS, 40 * MS), ("train.evaluate", 40 * MS, 50 * MS),
            ("aten::mm", 41 * MS, 43 * MS), ("train.record", 50 * MS, 58 * MS),
            ("train.replay", 60 * MS, 75 * MS)]
    device = [("dual_kernel", 20 * MS, 30 * MS), ("sgemm", 42 * MS, 48 * MS),
              ("dual_kernel", 65 * MS, 95 * MS)]
    return TraceView((0, 100 * MS), device, host)


def test_idle_split_between_replays_and_boundaries():
    view = _train_view()
    launch = _read("train.launch_idle_share", view)
    evals = _read("train.eval_idle_share", view)
    assert launch == pytest.approx(20 + 5)  # 0-20 and 60-65 of 100 ms
    assert evals == pytest.approx(12 + 2)  # 30-42 and 48-50; the record's 50-58 in neither
    assert view.idle_percent() == pytest.approx(54)  # 0-20, 30-42, 48-65, 95-100
    assert launch + evals <= view.idle_percent()


def test_idle_inside_spans_is_clipped_to_the_window():
    host = [("train.replay", -10 * MS, 5 * MS), ("train.evaluate", 8 * MS, 30 * MS)]
    view = TraceView((0, 10 * MS), [("k", 5 * MS, 6 * MS)], host)
    assert _read("train.launch_idle_share", view) == pytest.approx(50)
    assert _read("train.eval_idle_share", view) == pytest.approx(20)


def test_the_eval_idle_leaves_out_the_record():
    """The host waits at a record's first read for the interval's queued
    work; the card's gaps then are the replayed graph's, not the
    evaluation's."""
    host = [("train.replay", 0, 10 * MS), ("train.val_loss", 10 * MS, 12 * MS),
            ("train.evaluate", 12 * MS, 14 * MS), ("train.record", 14 * MS, 40 * MS)]
    device = [("dual_kernel", 5 * MS, 20 * MS), ("dual_kernel", 30 * MS, 40 * MS)]
    view = TraceView((0, 40 * MS), device, host)
    assert _read("train.eval_idle_share", view) == 0.0
    assert _read("train.launch_idle_share", view) == pytest.approx(12.5)  # 0-5 of 40 ms


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_window_without_spans_reads_none(name):
    device = [("fused_serve_kernel", 10 * MS, 12 * MS)]
    host = [("aten::to", 0, 9 * MS), ("cudaGraphLaunch", 20 * MS, 30 * MS)]
    assert _read(name, TraceView((0, 50 * MS), device, host)) is None
    assert _read(name, TraceView((0, 50 * MS))) is None


def test_idle_shares_need_the_card():
    host = [("train.replay", 0, 30 * MS), ("train.val_loss", 30 * MS, 40 * MS)]
    view = TraceView((0, 50 * MS), [], host)  # a CPU run: nothing on a card
    assert _read("train.launch_idle_share", view) is None
    assert _read("train.eval_idle_share", view) is None


def test_a_pass_cut_by_the_window_reads_none():
    view = TraceView((0, 50 * MS), [("k", 0, 1 * MS)],
                     [("serve.pass", 10 * MS, 60 * MS), ("serve.build", 10 * MS, 20 * MS)])
    assert _read("serve.build_share", view) is None


def test_h2d_mb_per_pass_is_the_counters_ratio():
    U, I = 6040, 3706
    counts = {"serve_passes": 7, "serve_h2d_bytes": 7 * 5 * U * I}
    assert _read("serve.h2d_mb_per_pass", TraceView((0, 1)), counts) == pytest.approx(111.9212)
    assert _read("serve.h2d_mb_per_pass", TraceView((0, 1)),
                 {"serve_passes": 0, "serve_h2d_bytes": 0}) is None
    assert _read("serve.h2d_mb_per_pass", TraceView((0, 1))) is None


def test_h2d_counters_resolve_to_the_program():
    from lgcnhs_tpu_torch.models import fusion

    reader = harness.load_metric("serve.h2d_mb_per_pass")
    read = {name: harness._read_counter(path) for name, path in reader.COUNTERS.items()}
    assert read == {"serve_passes": fusion.serve_fused.passes,
                    "serve_h2d_bytes": fusion.serve_fused.h2d_bytes}


def test_a_program_without_the_counters_leaves_them_unread(monkeypatch):
    fusion = importlib.import_module("lgcnhs_tpu_torch.models.fusion")
    monkeypatch.delattr(fusion.serve_fused, "h2d_bytes")
    monkeypatch.delattr(fusion.serve_fused, "passes")
    reader = harness.load_metric("serve.h2d_mb_per_pass")
    assert reader.COUNTERS == {}
    ctx = harness.Context(TraceView((0, 1)), {}, {}, {}, {})
    assert reader.read(ctx) is None


def test_span_helpers():
    assert spans.union([(5, 7), (0, 2), (1, 3), (7, 9), (4, 4)]) == [(0, 3), (5, 9)]
    assert spans.overlap([(0, 3), (5, 9)], [(2, 6), (8, 20)]) == 1 + 1 + 1
    assert spans.length([(0, 3), (5, 9)]) == 7

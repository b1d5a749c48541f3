"""The work counts against hand-worked counts at ML-1M's shapes, and the
readers on hand-made traces."""
import pytest

from portbench import harness
from portbench.drivers.train import Interval
from portbench.trace import TraceView

PEAKS = harness.peaks()
# ML-1M: 6,040 users, 3,706 items, 804,654 train pairs, 905,236 train+val pairs
TRAIN = {"U": 6040, "I": 3706, "nnz": 804654, "D": 64, "L": 3, "k": 100, "batch": 1024}
SERVE = dict(TRAIN, nnz=905236)


def test_peaks_are_the_data_sheet_h100():
    assert PEAKS["bf16_flops_per_s"] == 989e12 and PEAKS["hbm_bytes_per_s"] == 3.35e12


def test_dual_matmul_count():
    m = harness.load_metric("dual_matmul_roofline")
    flops, nbytes = m.work(TRAIN)
    assert flops == 4 * 804654 * 64 == 205_991_424
    # bitmap 6040*3706/8 = 2,798,030 < edge list 6,437,232; bf16 in 1,247,488; f32 out 2,494,976
    assert nbytes == 2_798_030 + 1_247_488 + 2_494_976 == 6_540_494
    assert m.least_seconds(TRAIN, PEAKS) == pytest.approx(6_540_494 / 3.35e12)  # bytes bound


def test_fused_serve_count():
    m = harness.load_metric("fused_serve_roofline")
    flops, nbytes = m.work(SERVE)
    assert flops == 2 * 6040 * 3706 * 64 + 2 * 905236 * 3706 == 9_574_791_952
    # bitmap 2,798,030; tables 1,247,488; W 3706^2 * 2 = 27,468,872; lists 6040 * 100 * 8
    assert nbytes == 2_798_030 + 1_247_488 + 27_468_872 + 4_832_000 == 36_346_390
    assert m.least_seconds(SERVE, PEAKS) == pytest.approx(36_346_390 / 3.35e12)


def test_step_and_pass_flops():
    assert harness.load_metric("train_step_mfu").step_flops(TRAIN) == 1_235_948_544
    assert harness.load_metric("serve_pass_mfu").pass_flops(SERVE) == 9_574_791_952


def test_graph_counted_as_the_smaller_layout():
    m = harness.load_metric("dual_matmul_roofline")
    sparse = dict(TRAIN, U=29858, I=40981, nnz=821_000)
    _, nbytes = m.work(sparse)
    assert nbytes == 8 * 821_000 + (29858 + 40981) * 64 * 6


def _ctx(view, records=None, shapes=TRAIN, counts=None):
    return harness.Context(view, records or {}, shapes, PEAKS, counts or {})


def test_roofline_reads_the_launches_and_refuses_a_mismatch():
    ms = 1_000_000
    ops = [("void dual_kernel<signed char>(...)", i * ms, i * ms + 50_000) for i in range(6)]
    ops += [("dual_reduce_kernel(...)", 7 * ms, 7 * ms + 6_000)]
    view = TraceView((0, 10 * ms), ops)
    m = harness.load_metric("dual_matmul_roofline")
    per_launch = (6 * 50_000 + 6_000) / 1e9 / 6
    got = m.read(_ctx(view, counts={"dual_matmul": 6}))
    assert got == pytest.approx(100 * (6_540_494 / 3.35e12) / per_launch)
    assert m.read(_ctx(view, counts={"dual_matmul": 7})) is None
    assert m.read(_ctx(TraceView((0, 10 * ms)), counts={"dual_matmul": 0})) is None


def test_idle_share_and_gaps():
    view = TraceView((0, 1000), [("k1", 100, 300), ("k2", 200, 400), ("Memcpy HtoD", 900, 1100)],
                     [("host.build", 450, 850), ("aten::outer", 0, 1000)])
    assert view.busy_s() == pytest.approx(400 / 1e9)
    assert harness.load_metric("device_idle.train").read(_ctx(view)) == pytest.approx(60.0)
    gaps = view.idle_gaps()
    assert gaps[0] == ["host.build", pytest.approx(500 / 1e9)]
    assert gaps[1] == ["aten::outer", pytest.approx(100 / 1e9)]


def test_eval_share_and_host_share():
    intervals = [Interval(0, 1000, 200, "eval", 800), Interval(1000, 2000, 200, "eval", 1900),
                 Interval(2000, 5000, 1, "job_start", None)]
    share = harness.load_metric("train.eval_share").read(_ctx(TraceView((0, 5000)),
                                                            {"intervals": intervals}))
    assert share == pytest.approx(100 * 300 / 2000)
    view = TraceView((0, 2000), [("Memcpy HtoD", 50, 90), ("gemm", 100, 150), ("gemm", 1700, 1800)])
    passes = [(0, 1000, 1e-6), (1000, 2000, 1e-6)]
    host = harness.load_metric("serve.host_share").read(_ctx(view, {"passes": passes}))
    assert host == pytest.approx(100 * (100 + 700) / 2000)


def test_mfu_reads_the_window_rate():
    view = TraceView((0, 2_000_000_000), [("k", 0, 10)])
    intervals = [Interval(0, 1, 400, "eval", None), Interval(1, 2, 600, "eval", None)]
    got = harness.load_metric("train_step_mfu").read(_ctx(view, {"intervals": intervals}))
    assert got == pytest.approx(100 * 500 * 1_235_948_544 / 989e12)

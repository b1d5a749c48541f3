"""Both drivers end to end on the CPU at a tiny size: the result line's
shape, the reference against the port, and the faults the check has to
catch, each planted in the timed path underneath."""
import json

import numpy as np
import pytest
import torch

from portbench import judge
from portbench.tests import tiny


def _shape_ok(line, trace=False):
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert {"metrics", "device"} <= set(line)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    json.dumps(line)


def test_train_driver_line_and_check(monkeypatch):
    from portbench.drivers import train

    seen = []
    check = train.check
    monkeypatch.setattr(train, "check", lambda o, d: seen.append(o) or check(o, d))
    line = tiny.run("ml1m-train")
    _shape_ok(line)
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"train_examples_per_s", "peak_mem_gib", "setup_s"}
    assert line["attempted"] > 0 and line["metrics"]["train_examples_per_s"]["value"] > 0
    # judged: both jobs' starts, the window's first interval (the return of
    # the first job) and an interval of the second job that ends in an eval
    (outcome,) = seen
    assert len(outcome.starts) == 2
    spans = [(s.epoch0, s.n, s.readout.row is not None) for s in outcome.spans]
    assert spans[0] == (401, 199, False) and any(row for _, _, row in spans[1:]), spans
    kinds = [iv.kind for iv in outcome.records["intervals"]]
    assert kinds[:3] == ["return", "job_start", "eval"], kinds


@pytest.mark.parametrize("cell", ["ml1m-serve", "gowalla-serve"])
def test_serve_driver_line_and_check(cell):
    line = tiny.run(cell)
    _shape_ok(line)
    assert line["correct"] is True, line["checks"]
    want = {"serve_users_per_s", "peak_mem_gib", "setup_s"}
    if cell == "ml1m-serve":
        want.add("serve_pass_p95_ms")
    assert set(line["metrics"]) == want


def test_traced_line_on_the_cpu_has_no_device_metric():
    line = tiny.run("ml1m-serve", trace=True)
    _shape_ok(line)
    assert line["metrics"] == {}  # no card: nothing on the device to read
    assert line["device"]["busy_s"] == 0 and "breakdown" in line


def test_train_fault_state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    line = tiny.run("ml1m-train")
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["interval_change_gap"]["value"] == pytest.approx(1.0)


def test_train_fault_lr_left_undecayed(monkeypatch):
    from lgcnhs_tpu_torch.train import trainer

    monkeypatch.setattr(trainer, "lr_schedule", lambda lr0, gamma, every: lambda step: lr0)
    line = tiny.run("ml1m-train")
    assert line["correct"] is False
    assert line["checks"]["interval_change_gap"]["value"] > 0.01


def test_train_fault_evaluation_answer_altered(monkeypatch):
    from lgcnhs_tpu_torch.ops import metrics_ops

    ndcg = metrics_ops.ndcg_at_k
    monkeypatch.setattr(metrics_ops, "ndcg_at_k", lambda *a: ndcg(*a) * 1.01)
    line = tiny.run("ml1m-train")
    assert line["correct"] is False
    assert line["checks"]["eval_gap"]["value"] == pytest.approx(1e-2, rel=1e-3)


def test_train_fault_half_batch(monkeypatch):
    from lgcnhs_tpu_torch.train import trainer

    full = trainer.bpr_loss

    def half(*rows, **kw):
        n = rows[0].shape[0] // 2
        return full(*(r[:n] for r in rows[:6]), *rows[6:], **kw)

    monkeypatch.setattr(trainer, "bpr_loss", half)
    line = tiny.run("ml1m-train")
    assert line["correct"] is False
    assert line["checks"]["interval_change_gap"]["value"] > 1e-3


def _serving_fault(monkeypatch, alter):
    from lgcnhs_tpu_torch.models import fusion

    served = fusion.serve_fused

    def faulty(*a, **k):
        return alter(served(*a, **k).copy())

    monkeypatch.setattr(fusion, "serve_fused", faulty)
    return tiny.run("ml1m-serve")


def test_serve_fault_answer_altered(monkeypatch):
    def alter(rec):
        rec[:, 0] = rec[:, -1]
        return rec

    assert _serving_fault(monkeypatch, alter)["correct"] is False


def test_serve_fault_half_the_users_left_out(monkeypatch):
    def alter(rec):
        rec[rec.shape[0] // 2:] = 0
        return rec

    assert _serving_fault(monkeypatch, alter)["correct"] is False


def test_score_gap_reads_order_seen_and_repeats():
    scores = torch.tensor([[3.0, 2.0, -torch.inf, 1.0], [1.0, 4.0, 2.0, 0.5]], dtype=torch.float64)
    assert judge.score_gap(np.array([[0, 1], [1, 2]]), scores) == 0.0
    assert judge.score_gap(np.array([[1, 0], [1, 2]]), scores) == pytest.approx(1 / 3)
    assert judge.score_gap(np.array([[0, 2], [1, 2]]), scores) == float("inf")
    assert judge.score_gap(np.array([[0, 0], [1, 2]]), scores) == float("inf")
    assert judge.score_gap(np.array([[0, 4], [1, 2]]), scores) == float("inf")


def test_run_refuses_without_a_card(capsys):
    from portbench import run

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "ml1m-train", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""

"""``--profile`` in the port: ``runtime/logging.profile_trace`` records a
``torch.profiler`` trace where the JAX package records a ``jax.profiler`` one
(``tests/test_reference_differential.py::test_profile_trace_writes_trace``).

- The trace is one ``rank<r>.<ns>.pt.trace.json`` that ``json.load``s with
  the body's operator events; ``None`` and ``""`` record nothing; under a
  process group the file is named by the rank.
- ``cli/main --device cpu --profile DIR`` writes the trace and prints the
  same metric line as the same run without it.
"""
import json

import torch

from lgcnhs_tpu_torch.cli import main as t_main
from lgcnhs_tpu_torch.runtime import logging as tlogging
from lgcnhs_tpu_torch.runtime.logging import profile_trace

SIZE = ["--dataset", "synthetic", "--env", "dev", "--users", "40", "--items", "60",
        "--interactions", "1500", "--device", "cpu"]


def _trace(directory):
    files = sorted(directory.glob("*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return files[0].name, json.load(f)


def test_profile_trace_writes_a_loadable_trace(tmp_path):
    with profile_trace(str(tmp_path / "trace"), "cpu"):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
    name, trace = _trace(tmp_path / "trace")
    assert name.startswith("rank0.")
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names

    for off in (None, ""):
        with profile_trace(off, "cpu"):
            torch.ones(2).sum()
    assert [p.name for p in tmp_path.iterdir()] == ["trace"]


def test_profile_trace_names_the_file_by_rank(tmp_path, monkeypatch):
    monkeypatch.setattr(tlogging, "rank", lambda: 3)
    with profile_trace(str(tmp_path), "cpu"):
        torch.ones(4).sum()
    assert _trace(tmp_path)[0].startswith("rank3.")


def test_cli_main_profile_keeps_the_metric_line(tmp_path, capsys):
    argv = SIZE + ["--model", "LightGCNOpti", "--epochs", "4", "--workdir", str(tmp_path / "w"),
                   "--no-cache"]
    plain = t_main.main(argv)
    plain_line = capsys.readouterr().out.strip().splitlines()[-1]
    profiled = t_main.main(argv + ["--profile", str(tmp_path / "trace")])
    profiled_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert profiled == plain
    assert profiled_line == plain_line == json.dumps({"model": "LightGCNOpti", "k": 10, **plain})
    _, trace = _trace(tmp_path / "trace")
    assert any(e.get("name") == "aten::mm" for e in trace["traceEvents"])

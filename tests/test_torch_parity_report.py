"""``cli/parity_report`` and ``eval/reference_runner`` against the JAX package.

Neither this suite's machine nor the card's holds the reference checkout, so
a stand-in tree is written under ``tmp_path``
(``torch_port_checks.write_reference_standin``: the five files
``_reference_metrics`` loads, each importing the reference's stubbed
globals, each delegating to the JAX package). Both packages'
``parity_report`` modules get ``reference_available`` and a
``ReferenceModules`` bound to that tree; JAX's ``main`` and the port's then
run with ``tests/test_cli_aux.py``'s arguments (synthetic 60 x 90, ks 4 and
7; the port with ``--device cpu``) in two workdirs:

- the summaries are equal (``all_match`` true), the CSVs byte-identical,
  the markdown tables equal cell by cell;
- a stand-in that swaps two tied items: ``rec_identical`` false,
  ``tie_equivalent`` true, ``all_match`` true in both;
- a shifted P alone: ``match`` false, and ``all_match`` still true in both
  (identical lists vouch for the cell); with an item of another score in a
  list too, ``all_match`` false in both;
- the movielens and douban quirk runs agree (``test_cli_aux.py:79-90``);
- ``ReferenceModules`` restores ``sys.modules`` on exit in both packages;
- without the reference both return ``{"reference": False}``.
"""
import functools
import json
import os
import sys

import jax
import pytest

from lgcnhs_tpu.cli import parity_report as j_report
from lgcnhs_tpu.eval import reference_runner as j_runner
from lgcnhs_tpu_torch.cli import parity_report as t_report
from lgcnhs_tpu_torch.eval import reference_runner as t_runner
from torch_port_checks import write_reference_standin

SMALL = ["--env", "dev", "--users", "60", "--items", "90", "--interactions", "2000"]


@pytest.fixture(autouse=True)
def restore_x64():
    """JAX's parity_report leaves x64 on when it returns without the reference."""
    was = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", was)


def _standin(tmp_path, monkeypatch, **alter):
    root = tmp_path / "reference"
    write_reference_standin(root, **alter)
    for report, runner in ((j_report, j_runner), (t_report, t_runner)):
        monkeypatch.setattr(report, "reference_available", lambda: True)
        monkeypatch.setattr(report, "ReferenceModules",
                            functools.partial(runner.ReferenceModules, ref_root=root))


def _both(tmp_path, argv):
    """(JAX summary, port summary, JAX evaluation dir, port evaluation dir)."""
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    want = j_report.main(argv + ["--workdir", str(jdir)])
    got = t_report.main(argv + ["--workdir", str(tdir), "--device", "cpu"])
    for summary, workdir in ((want, jdir), (got, tdir)):
        assert summary["report"].startswith(str(workdir))
    return ({k: v for k, v in want.items() if k != "report"},
            {k: v for k, v in got.items() if k != "report"},
            os.path.dirname(want["report"]), os.path.dirname(got["report"]))


def _tables(path):
    """{k: [header cells, row cells...]} of a parity_report.md."""
    tables, k = {}, None
    with open(path) as f:
        for line in f:
            if line.startswith("## k="):
                k = int(line[5:])
                tables[k] = []
            elif line.startswith("|") and not line.startswith("|:") \
                    and not line.startswith("|-"):
                tables[k].append([c.strip() for c in line.strip().strip("|").split("|")])
    return tables


def _rows(eval_dir, k):
    with open(os.path.join(eval_dir, f"parity_report_{k}.csv")) as f:
        lines = f.read().splitlines()
    header = lines[0].split(",")
    return [dict(zip(header, line.split(","))) for line in lines[1:]]


def test_faithful_reference_matches_jax(tmp_path, monkeypatch, capsys):
    _standin(tmp_path, monkeypatch)
    want, got, jeval, teval = _both(tmp_path, ["--dataset", "synthetic", *SMALL,
                                               "--ks", "4", "7"])
    assert got == want
    assert got == {"reference": True, "models": ["ProbS", "HeatS", "HybridS"], "ks": [4, 7],
                   "all_match": True}
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["all_match"] is True
    for k in (4, 7):
        with open(os.path.join(jeval, f"parity_report_{k}.csv"), "rb") as f:
            jcsv = f.read()
        with open(os.path.join(teval, f"parity_report_{k}.csv"), "rb") as f:
            assert f.read() == jcsv
        assert all(r["match"] == r["rec_identical"] == "True" for r in _rows(teval, k))
    jtab = _tables(os.path.join(jeval, "parity_report.md"))
    assert list(jtab) == [4, 7] and len(jtab[4]) == 4
    assert _tables(os.path.join(teval, "parity_report.md")) == jtab


def test_swapped_tie_is_tie_equivalent(tmp_path, monkeypatch):
    """500 interactions: sparse enough for tied scores in every method's lists
    (2000 give none)."""
    _standin(tmp_path, monkeypatch, swap_tie=True)
    sparse = SMALL[:-1] + ["500"]
    want, got, jeval, teval = _both(tmp_path, ["--dataset", "synthetic", *sparse, "--ks", "7"])
    assert got == want and got["all_match"] is True
    rows = _rows(teval, 7)
    assert rows == _rows(jeval, 7)
    assert all(r["rec_identical"] == "False" and r["tie_equivalent"] == "True" for r in rows)


@pytest.mark.parametrize("replace_item", [False, True])
def test_shifted_metric(tmp_path, monkeypatch, replace_item):
    _standin(tmp_path, monkeypatch, shift=1e-3, replace_item=replace_item)
    want, got, jeval, teval = _both(tmp_path, ["--dataset", "synthetic", *SMALL, "--ks", "4"])
    assert got == want
    assert got["all_match"] is not replace_item
    rows = _rows(teval, 4)
    assert rows == _rows(jeval, 4)
    assert all(r["match"] == "False" for r in rows)
    assert rows[0]["tie_equivalent"] == str(not replace_item)


@pytest.mark.parametrize("dataset", ["movielens", "douban"])
def test_quirk_datasets_match_jax(tmp_path, monkeypatch, dataset):
    """ProbS-on-movielens (skip-filter, transposed W) and HeatS-on-douban
    (transposed W); douban's quantile band is disabled, as the JAX test does."""
    _standin(tmp_path, monkeypatch)
    want, got, jeval, teval = _both(tmp_path, ["--dataset", dataset, *SMALL, "--ks", "4",
                                               "--quantile", "1", "0"])
    assert got == want and got["all_match"] is True
    with open(os.path.join(jeval, "parity_report_4.csv"), "rb") as f:
        jcsv = f.read()
    with open(os.path.join(teval, "parity_report_4.csv"), "rb") as f:
        assert f.read() == jcsv


def test_reference_modules_restore_sys_modules(tmp_path):
    root = tmp_path / "reference"
    write_reference_standin(root)
    for runner in (j_runner, t_runner):
        sentinel = object()
        sys.modules["const"] = sentinel
        try:
            with runner.ReferenceModules(str(tmp_path), ref_root=root) as ref:
                assert sys.modules["const"].cfg is ref.cfg
                assert sys.modules["metrics.accurate"] is ref.accurate
            assert sys.modules["const"] is sentinel
            assert all(n not in sys.modules for n in runner.ReferenceModules._STUBBED
                       if n != "const")
        finally:
            sys.modules.pop("const", None)


def test_without_the_reference(tmp_path, monkeypatch, capsys):
    for report in (j_report, t_report):
        monkeypatch.setattr(report, "reference_available", lambda: False)
    argv = ["--dataset", "synthetic", *SMALL, "--workdir", str(tmp_path)]
    assert j_report.main(argv) == {"reference": False}
    assert t_report.main(argv + ["--device", "cpu"]) == {"reference": False}
    assert capsys.readouterr().out.strip().splitlines()[-2:] == ['{"reference": false}'] * 2

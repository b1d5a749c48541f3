"""The report entry points against the JAX package: ``cli/evaluate`` (CSV and
workbook), ``cli/ablation``, the port's xlsx writer and its pandas-free CSV
tables (``runtime/table``).

- ``cli/evaluate`` on the same cached lists in two workdirs: every
  ``model_evaluation_<k>.csv`` byte-identical to the JAX CLI's, and
  every member of the workbook identical to the JAX CLI's built-in
  writer (openpyxl forced off as ``tests/test_cli.py`` forces it; the zip
  members' timestamps are not compared). Skips: a model with no cached
  list, a list with fewer than k columns.
- ``write_xlsx``: non-finite cells as inline strings
  (``tests/test_cli.py:102``), the parts identical to the JAX writer's.
- ``cli/ablation``: a chart from the evaluation CSV, nothing without it,
  and a logged line and no chart where matplotlib does not import.
- ``runtime/table``: ``to_csv`` byte-identical to
  ``pandas.DataFrame.to_csv(index=False)`` on ints, floats, NaN, bools
  and strings; ``read_csv`` reads back the values and column types
  ``pandas.read_csv`` infers.
"""
import builtins
import math
import os
import xml.etree.ElementTree as ET
import zipfile

import numpy as np
import pandas as pd
import pytest

from lgcnhs_tpu.cli import evaluate as j_evaluate
from lgcnhs_tpu.runtime import xlsx as jxlsx
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import ablation as t_ablation
from lgcnhs_tpu_torch.cli import evaluate as t_evaluate
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.data.graph import build_graph
from lgcnhs_tpu_torch.runtime import table
from lgcnhs_tpu_torch.runtime import xlsx as txlsx
from lgcnhs_tpu_torch.runtime.cache import ArtifactCache

SIZE = ["--dataset", "synthetic", "--env", "dev", "--users", "60", "--items", "90",
        "--interactions", "1500"]
OVER = {"synthetic_users": 60, "synthetic_items": 90, "synthetic_interactions": 1500}
NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _cached_lists(workdirs):
    """The same seeded lists in each workdir's cache: HybridS and
    SpreadLightGCNOpti at k=5 and k=10, a 7-column HeatS list under both
    keys (cut to 5 at k=5, skipped at k=10), nothing for ProbS."""
    cfg = tcfg.load_config(dataset="synthetic", workdir=workdirs[0], overrides=OVER)
    graph = build_graph(load_dataset(cfg)[0])
    rng = np.random.default_rng(0)
    lists = {model: np.argsort(rng.random((graph.n_users, graph.n_items)), axis=1)[:, :width]
             .astype(np.int32)
             for model, width in (("HybridS", 10), ("SpreadLightGCNOpti", 10), ("HeatS", 7))}
    for workdir in workdirs:
        cache = ArtifactCache(tcfg.load_config(dataset="synthetic", workdir=workdir,
                                               overrides=OVER).recommend_path)
        for model, rec in lists.items():
            cache.save_recommendations(f"all_user_recommend_{model}_10", rec)
            cache.save_recommendations(f"all_user_recommend_{model}_5",
                                       rec if model == "HeatS" else rec[:, :5])
    return graph


def _members(path):
    with zipfile.ZipFile(path) as zf:
        return {info.filename: zf.read(info.filename) for info in zf.infolist()}


def test_evaluate_matches_jax(tmp_path, monkeypatch):
    monkeypatch.setattr(pd, "ExcelWriter", lambda *a, **kw: (_ for _ in ()).throw(
        ImportError("forced: the JAX CLI's built-in xlsx writer")))
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _cached_lists([jdir, tdir])
    argv = SIZE + ["--ks", "5", "10", "--models", "HybridS", "HeatS", "ProbS",
                   "SpreadLightGCNOpti"]
    want = j_evaluate.main(argv + ["--workdir", jdir])
    got = t_evaluate.main(argv + ["--workdir", tdir, "--device", "cpu"])
    assert sorted(got) == sorted(want) == [5, 10]
    assert [r["Model"] for r in got[10]] == ["HybridS", "SpreadLightGCNOpti"]
    assert [r["Model"] for r in got[5]] == ["HybridS", "HeatS", "SpreadLightGCNOpti"]
    for k in (5, 10):
        assert got[k] == want[k].to_dict("records")
    evaluation = [tcfg.load_config(dataset="synthetic", workdir=w, overrides=OVER)
                  .evaluation_path for w in (jdir, tdir)]
    for k in (5, 10):
        name = f"model_evaluation_{k}.csv"
        with open(os.path.join(evaluation[0], name), "rb") as f:
            want_csv = f.read()
        with open(os.path.join(evaluation[1], name), "rb") as f:
            assert f.read() == want_csv
    j_book, t_book = (_members(os.path.join(e, "model_evaluation_results.xlsx"))
                      for e in evaluation)
    assert list(t_book) == list(j_book)
    assert t_book == j_book
    sheet = ET.fromstring(t_book["xl/worksheets/sheet2.xml"])
    assert len(list(sheet.iter(f"{NS}row"))) == 3  # the header and two models at k=10


def test_write_xlsx_nonfinite_cells_are_inline_strings(tmp_path):
    sheets = {"s": [["a", 1.5, float("nan"), float("inf"), 2]], "t<&>": [["x"], [3.25]]}
    paths = [str(tmp_path / f"{name}.xlsx") for name in ("j", "t")]
    jxlsx.write_xlsx(paths[0], sheets)
    txlsx.write_xlsx(paths[1], sheets)
    assert _members(paths[1]) == _members(paths[0])
    sheet = ET.fromstring(_members(paths[1])["xl/worksheets/sheet1.xml"])
    cells = list(sheet.iter(f"{NS}c"))
    assert [c.get("t") for c in cells] == ["inlineStr", None, "inlineStr", "inlineStr", None]
    assert [float(c.find(f"{NS}v").text) for c in cells if c.get("t") is None] == [1.5, 2.0]
    with pytest.raises(ValueError):
        txlsx.write_xlsx(paths[1], {})


def _evaluation_csv(tmp_path):
    workdir = str(tmp_path)
    cfg = tcfg.load_config(dataset="synthetic", workdir=workdir, overrides=OVER)
    cfg.ensure_dirs()
    rows = [{"Model": m, "P": 0.1 * j, "R": 0.2, "F1": 0.13333, "NDCG": 0.3, "H": 0.9,
             "I": 0.25} for j, m in enumerate(("HybridS", "SpreadLightGCN",
                                               "SpreadLightGCNOpti"))]
    table.write_csv(os.path.join(cfg.evaluation_path, "model_evaluation_10.csv"),
                    table.rows_to_columns(rows))
    return workdir


def test_ablation_chart_from_the_evaluation_csv(tmp_path):
    workdir = _evaluation_csv(tmp_path)
    outputs = t_ablation.main(["--dataset", "synthetic", "--workdir", workdir, "--ks", "10",
                               "99"])
    assert len(outputs) == 1 and outputs[0].endswith("ablation_10.png")
    assert os.path.getsize(outputs[0]) > 0


def test_ablation_without_csv_or_matplotlib_draws_nothing(tmp_path, monkeypatch):
    assert t_ablation.main(["--dataset", "synthetic", "--workdir", str(tmp_path / "empty"),
                            "--ks", "99"]) == []
    workdir = _evaluation_csv(tmp_path)
    real_import = builtins.__import__

    def no_matplotlib(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError(f"no module named {name}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    assert t_ablation.main(["--dataset", "synthetic", "--workdir", workdir, "--ks", "10"]) == []


TABLES = {
    "history": {"iters": [0, 200, 400], "train_loss": [-0.84088, -12.47871, -0.1],
                "val_loss": [3.1, float("nan"), -15.32947], "val_H": [1.0, 0.99999, 1e-05]},
    "report": {"Model": ["HybridS", "Spread,LightGCN", 'a "quoted" name'],
               "P": [0.1, 0.0, 1e16], "R": [1, 2.5, float("nan")], "H": [1, 2, 3]},
    "mixed": {"flag": [True, False, True], "obj": ["x", 1.5, float("nan")],
              "f": [-0.0, float("inf"), 123456789.123], "g": [0.0001, 3e-4, 2 / 3]},
    "sweep": table.rows_to_columns([{"lambda": round(0.01 * j, 4), "P": 0.07073, "F1": 0.0}
                                    for j in range(0, 101, 25)]),
    "empty": {"iters": [], "train_loss": []},
}


@pytest.mark.parametrize("name", list(TABLES))
def test_table_csv_matches_pandas(tmp_path, name):
    columns = TABLES[name]
    want = pd.DataFrame(columns).to_csv(index=False)
    assert table.to_csv(columns) == want
    path = str(tmp_path / "t.csv")
    table.write_csv(path, columns)
    with open(path, newline="") as f:
        assert f.read() == want
    got, ref = table.read_csv(path), pd.read_csv(path)
    assert list(got) == list(ref.columns)
    for col in ref.columns:
        values = ref[col].tolist()
        if ref[col].dtype == bool:
            values = [str(v) for v in values]  # bools are read back as their strings
        assert len(got[col]) == len(values)
        for g, w in zip(got[col], values):
            assert (isinstance(g, float) and isinstance(w, float) and math.isnan(g)
                    and math.isnan(w)) or (g == w and type(g) is type(w)), (col, g, w)

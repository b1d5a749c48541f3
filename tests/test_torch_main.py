"""The main path as a whole: ``lgcnhs_tpu.cli.main`` and
``lgcnhs_tpu_torch.cli.main`` for all seven models on one small synthetic
config, with one shared pair of npz checkpoints (LightGCN-shaped for
LightGCN and SpreadLightGCN, LightGCNOpti-shaped for the Opti models).

The two entry points must write identical (U, k) lists and print identical
metric JSON lines (5-decimal values compared for equality). Also: the
cached list is read back, ``--no-cache`` recomputes, the target-user
flags, training on a missing checkpoint, and float64 checkpoints against
the JAX package under x64.
"""
import json
import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from lgcnhs_tpu.cli import main as j_main
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import main as t_main
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.data.graph import build_graph
from lgcnhs_tpu_torch.models import lightgcn as tlgcn
from lgcnhs_tpu_torch.models.recommenders import checkpoint_path
from lgcnhs_tpu_torch.train import trainer as ttrainer

MODELS = ["ProbS", "HeatS", "HybridS", "LightGCN", "LightGCNOpti",
          "SpreadLightGCN", "SpreadLightGCNOpti"]
SIZE = ["--dataset", "synthetic", "--env", "dev", "--users", "150",
        "--items", "240", "--interactions", "5000", "--k", "10"]
OVER = {"k": 10, "synthetic_users": 150, "synthetic_items": 240,
        "synthetic_interactions": 5000}


def _config(model, workdir):
    return tcfg.load_config(dataset="synthetic", model=model, workdir=workdir, overrides=OVER)


def _write_checkpoints(workdirs, seed, dtype=torch.float32):
    """Seeded continuous tables of both embedding models, written into each
    workdir where both entry points look for them."""
    splits, uf, itf = load_dataset(_config("LightGCN", workdirs[0]))
    graph = build_graph(splits)
    gen = torch.Generator().manual_seed(seed)
    tables = {"LightGCN": tlgcn.init_lightgcn(gen, graph.n_users, graph.n_items, 16),
              "LightGCNOpti": tlgcn.init_lightgcn_opti(gen, uf, itf, 16)}
    for workdir in workdirs:
        for name, params in tables.items():
            path = checkpoint_path(_config(name, workdir))
            os.makedirs(os.path.dirname(path), exist_ok=True)
            ttrainer.save_checkpoint(path, tlgcn.LightGCNParams(*(t.to(dtype) for t in params)))
    return graph


def _saved_list(model, workdir):
    return np.load(os.path.join(_config(model, workdir).recommend_path,
                                f"all_user_recommend_{model}_10.npy"))


def _json_line(out):
    return [line for line in out.splitlines() if line.startswith('{"model"')][-1]


@pytest.fixture
def log_lines():
    """Messages the ``lgcnhs`` logger emits during the test."""
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Keep(level=logging.DEBUG)
    logger = logging.getLogger("lgcnhs")
    logger.addHandler(handler)
    yield lines
    logger.removeHandler(handler)


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Both workdirs with the shared checkpoints, and the graph."""
    root = tmp_path_factory.mktemp("main")
    workdirs = (str(root / "j"), str(root / "t"))
    return workdirs, _write_checkpoints(workdirs, seed=0)


@pytest.mark.parametrize("model", MODELS)
def test_main_matches_jax(model, shared, capsys):
    (jdir, tdir), graph = shared
    want = j_main.main(["--platform", "cpu", "--model", model, "--workdir", jdir, *SIZE])
    want_line = _json_line(capsys.readouterr().out)
    got = t_main.main(["--device", "cpu", "--model", model, "--workdir", tdir, *SIZE])
    got_line = _json_line(capsys.readouterr().out)
    want_rec, got_rec = _saved_list(model, jdir), _saved_list(model, tdir)
    assert got_rec.shape == (graph.n_users, 10)
    np.testing.assert_array_equal(got_rec, want_rec)
    assert got == want
    assert got_line == want_line
    assert json.loads(got_line) == {"model": model, "k": 10, **want}


def test_cached_list_is_read_and_no_cache_recomputes(tmp_path, log_lines, capsys):
    workdir = str(tmp_path)
    _write_checkpoints([workdir], seed=1)
    args = ["--device", "cpu", "--model", "SpreadLightGCNOpti", "--workdir", workdir, *SIZE]
    first = t_main.main(args)
    rec = _saved_list("SpreadLightGCNOpti", workdir)
    key = "all_user_recommend_SpreadLightGCNOpti_10"
    assert f"loaded cached recommendations: {key}" not in log_lines
    assert t_main.main(args) == first
    assert f"loaded cached recommendations: {key}" in log_lines

    # a cached list of the right shape is used as it is ...
    path = os.path.join(_config("SpreadLightGCNOpti", workdir).recommend_path, f"{key}.npy")
    np.save(path, np.zeros_like(rec))
    assert t_main.main(args) != first
    # ... unless --no-cache, which recomputes and writes the list again
    log_lines.clear()
    assert t_main.main([*args, "--no-cache"]) == first
    assert f"loaded cached recommendations: {key}" not in log_lines
    np.testing.assert_array_equal(np.load(path), rec)
    # a cached list of another shape is recomputed
    np.save(path, rec[:, :5])
    assert t_main.main(args) == first
    np.testing.assert_array_equal(np.load(path), rec)
    capsys.readouterr()


def test_target_user_flags(tmp_path, log_lines, capsys):
    workdir = str(tmp_path)
    _write_checkpoints([workdir], seed=2)
    args = ["--device", "cpu", "--model", "LightGCNOpti", "--workdir", workdir, *SIZE]
    t_main.main([*args, "--target-user-internal", "7"])
    rec = _saved_list("LightGCNOpti", workdir)
    assert f"recommendations for internal user 7: {rec[7].tolist()}" in log_lines
    with pytest.raises(SystemExit, match="data/idmap.py"):
        t_main.main([*args, "--target-user", "196"])
    capsys.readouterr()


def test_missing_checkpoint_trains_then_evaluates(tmp_path, capsys):
    workdir = str(tmp_path)
    got = t_main.main(["--device", "cpu", "--model", "SpreadLightGCNOpti",
                       "--workdir", workdir, "--epochs", "3", *SIZE])
    cfg = _config("SpreadLightGCNOpti", workdir)
    params = ttrainer.load_checkpoint(checkpoint_path(cfg))
    assert params.user_emb.shape[0] == 150 and params.item_emb.shape[0] == 240
    assert set(got) == {"P", "R", "F1", "NDCG", "H", "I"}
    assert all(0.0 <= v <= 1.0 for v in got.values())
    assert json.loads(_json_line(capsys.readouterr().out))["model"] == "SpreadLightGCNOpti"


@pytest.mark.parametrize("model", ["LightGCNOpti", "SpreadLightGCNOpti"])
def test_float64_checkpoint_matches_jax_x64(model, tmp_path, x64, capsys):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    _write_checkpoints([jdir, tdir], seed=3, dtype=torch.float64)
    assert ttrainer.load_checkpoint(
        checkpoint_path(_config(model, tdir))).user_emb.dtype == torch.float64
    want = j_main.main(["--platform", "cpu", "--model", model, "--workdir", jdir, *SIZE])
    got = t_main.main(["--device", "cpu", "--model", model, "--workdir", tdir, *SIZE])
    np.testing.assert_array_equal(_saved_list(model, tdir), _saved_list(model, jdir))
    assert got == want
    capsys.readouterr()


def test_main_needs_cuda_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        t_main.main(["--model", "ProbS", "--workdir", "unused", *SIZE])


def test_no_port_module_imports_jax():
    """Every module of the port, the new main path included, imports neither
    JAX nor the JAX package."""
    code = ("import importlib, pkgutil, sys, lgcnhs_tpu_torch as p; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(p.__path__, 'lgcnhs_tpu_torch.')]; "
            "import lgcnhs_tpu_torch.cli.main; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'lgcnhs_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr

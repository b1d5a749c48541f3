"""Ranks of the port started as a user starts them: the counterpart of
``tests/test_multihost.py``.

Every other mesh test of the port joins its ranks through a ``file://``
store. Here the process group comes from the two other branches of
``runtime/mesh.init_distributed``:

- ``env://``: ``python -m torch.distributed.run --standalone
  --nproc-per-node 2`` (torchrun) launches README's command lines, each
  held against the same command on one device:
  (i) ``cli/main --mesh 1,2 --device cpu --model SpreadLightGCNOpti`` on
  ``tests/test_torch_main.py``'s shared checkpoints: rank 0 prints exactly
  one JSON line, equal to the one-device port run's and to
  ``lgcnhs_tpu.cli.main``'s, and the list is identical to JAX's;
  (ii) the same launch at 50 x 80 x 2,000 with ``--epochs 20`` and no
  checkpoint, so the ranks train on the mesh: the checkpoint's tables
  within 1e-5 of the one-device run's (``tests/test_torch_mesh.py``'s bar
  at f32), an equal JSON line;
  (iii) ``cli/find_lambda --mesh 1,2``: the sweep CSV equal to the
  one-device run's.
- ``tcp://``: (iv) two processes of ``tests/torch_multihost_worker.py``
  each call ``init_distributed("127.0.0.1:<port>", 2, rank, "cpu")`` and
  run one ``make_sharded_train_step`` on a (1, 2) mesh: both print the
  same finite loss, within 1e-6 of the port's single-device step from the
  same tables and epoch generator, and the joined tables after the update
  lie within 1e-5 of that step's.

One CPU thread a rank (``OMP_NUM_THREADS=1``); every launch has its own
timeout, and ``--standalone`` lets torchrun pick a free port, so parallel
test workers never share one.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from lgcnhs_tpu.cli import main as j_main
from lgcnhs_tpu_torch import config as tcfg
from lgcnhs_tpu_torch.cli import find_lambda as t_fl
from lgcnhs_tpu_torch.cli import main as t_main
from lgcnhs_tpu_torch.models.recommenders import checkpoint_path
from lgcnhs_tpu_torch.train.trainer import load_checkpoint
from test_torch_main import SIZE, _json_line, _saved_list, _write_checkpoints
from test_torch_sweep import _size
from test_torch_sweep import _write_checkpoint as _write_sweep_checkpoint

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
MODEL = "SpreadLightGCNOpti"
TRAIN_SIZE = ["--dataset", "synthetic", "--env", "dev", "--users", "50", "--items", "80",
              "--interactions", "2000"]
TRAIN_OVER = {"synthetic_users": 50, "synthetic_items": 80, "synthetic_interactions": 2000}
SWEEP_SIZE = (50, 80, 2000)
LAUNCH_TIMEOUT_S = 240


def _env():
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _torchrun(module, args):
    """``torchrun --standalone --nproc-per-node 2 -m module args``: its
    standard output; fails the test unless it exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", module, *args],
        cwd=REPO, env=_env(), capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _lines(out):
    return [line for line in out.splitlines() if line.startswith('{"model"')]


@pytest.fixture(scope="module")
def shared_main(tmp_path_factory):
    """(i): the torchrun launch, the one-device port run and JAX's run of
    cli/main on one pair of shared checkpoints, in three workdirs."""
    root = tmp_path_factory.mktemp("multihost_main")
    tdir, onedir, jdir = (str(root / n) for n in ("t", "one", "j"))
    graph = _write_checkpoints([tdir, onedir, jdir], seed=0)
    out = _torchrun("lgcnhs_tpu_torch.cli.main",
                    ["--mesh", "1,2", "--device", "cpu", "--model", MODEL, "--workdir", tdir,
                     *SIZE])
    return graph, (tdir, onedir, jdir), out


def test_torchrun_main_prints_one_line_equal_to_one_device(shared_main, capsys):
    _, (tdir, onedir, _), out = shared_main
    lines = _lines(out)
    assert len(lines) == 1, out
    t_main.main(["--device", "cpu", "--model", MODEL, "--workdir", onedir, *SIZE])
    assert lines[0] == _json_line(capsys.readouterr().out)
    np.testing.assert_array_equal(_saved_list(MODEL, tdir), _saved_list(MODEL, onedir))


def test_torchrun_main_matches_jax(shared_main, capsys):
    graph, (tdir, _, jdir), out = shared_main
    want = j_main.main(["--platform", "cpu", "--model", MODEL, "--workdir", jdir, *SIZE])
    want_line = _json_line(capsys.readouterr().out)
    assert _lines(out) == [want_line]
    assert json.loads(want_line) == {"model": MODEL, "k": 10, **want}
    got = _saved_list(MODEL, tdir)
    assert got.shape == (graph.n_users, 10)
    np.testing.assert_array_equal(got, _saved_list(MODEL, jdir))


def test_torchrun_main_trains_on_the_mesh(tmp_path, capsys):
    """(ii): no checkpoint, so both runs train LightGCNOpti first."""
    tdir, onedir = str(tmp_path / "t"), str(tmp_path / "one")
    args = ["--device", "cpu", "--model", MODEL, "--epochs", "20", *TRAIN_SIZE]
    out = _torchrun("lgcnhs_tpu_torch.cli.main", ["--mesh", "1,2", "--workdir", tdir, *args])
    t_main.main(["--workdir", onedir, *args])
    one_line = _json_line(capsys.readouterr().out)
    assert _lines(out) == [one_line]
    tables = []
    for workdir in (tdir, onedir):
        cfg = tcfg.load_config(dataset="synthetic", model=MODEL, workdir=workdir,
                               overrides=TRAIN_OVER)
        params = load_checkpoint(checkpoint_path(cfg))
        assert params is not None, checkpoint_path(cfg)
        tables.append(params)
    (mesh_u, mesh_i), (one_u, one_i) = tables
    assert mesh_u.shape == one_u.shape and mesh_i.shape == one_i.shape
    torch.testing.assert_close(mesh_u, one_u, rtol=0, atol=1e-5)
    torch.testing.assert_close(mesh_i, one_i, rtol=0, atol=1e-5)


def test_torchrun_find_lambda_csv_equals_one_device(tmp_path):
    """(iii): the sweep on one shared checkpoint, under torchrun and on one
    device."""
    tdir, onedir = str(tmp_path / "t"), str(tmp_path / "one")
    cfgs = _write_sweep_checkpoint([tdir, onedir], *SWEEP_SIZE)
    args = [*_size(*SWEEP_SIZE), "--step", "0.25", "--device", "cpu"]
    _torchrun("lgcnhs_tpu_torch.cli.find_lambda", [*args, "--mesh", "1,2", "--workdir", tdir])
    t_fl.main([*args, "--workdir", onedir])
    csvs = []
    for cfg in cfgs:
        with open(os.path.join(cfg.evaluation_path, f"lambda_evaluation_{cfg.k}.csv"), "rb") as f:
            csvs.append(f.read())
    assert csvs[0] == csvs[1]
    assert csvs[0].count(b"\n") == 6  # the header and 5 grid points


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_step_over_tcp(tmp_path):
    """(iv): ``init_distributed("127.0.0.1:<port>", 2, rank, "cpu")``."""
    from lgcnhs_tpu_torch.data.graph import normalized_bipartite, pos_bool_matrix
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, init_lightgcn
    from lgcnhs_tpu_torch.train.trainer import epoch_generator, make_optimizer, make_train_step
    from torch_multihost_worker import D, I, INIT_SEED, U, hparams, toy_graph

    port, out = _free_port(), str(tmp_path / "tables.npz")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
                               str(rank), "2", str(port), out],
                              cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=LAUNCH_TIMEOUT_S)
            assert p.returncode == 0, f"worker failed:\n{stderr[-3000:]}"
            outs.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {}
    for stdout in outs:
        for line in stdout.splitlines():
            if line.startswith("RESULT "):
                _, rank, world, loss = line.split()
                results[int(rank)] = (int(world), float(loss))
    assert set(results) == {0, 1}, outs
    assert results[0] == results[1]
    world, loss = results[0]
    assert world == 2 and np.isfinite(loss)

    # the port's single-device step from the same tables and generator
    es = toy_graph()
    hp = hparams()
    init = init_lightgcn(torch.Generator().manual_seed(INIT_SEED), U, I, D)
    params = LightGCNParams(*(t.clone().requires_grad_(True) for t in init))
    step = make_train_step(make_optimizer(hp, params), hp, I)
    want = float(step(params, 0, epoch_generator(1, 0, torch.device("cpu")),
                      torch.from_numpy(normalized_bipartite(U, I, es)),
                      torch.from_numpy(es.users.astype(np.int64)),
                      torch.from_numpy(es.items.astype(np.int64)),
                      torch.from_numpy(pos_bool_matrix(U, I, es))))
    assert abs(loss - want) <= 1e-6, (loss, want)
    with np.load(out) as got:
        np.testing.assert_allclose(got["user_emb"], params.user_emb.detach().numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["item_emb"], params.item_emb.detach().numpy(),
                                   rtol=0, atol=1e-5)

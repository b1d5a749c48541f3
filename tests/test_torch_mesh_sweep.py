"""The sharded lambda sweeps and the mesh entry points of
``lgcnhs_tpu_torch`` on CPU ranks (``tests/torch_mesh_worker.py``, gloo).

- The sweeps on ``tests/test_torch_sweep.py``'s seeded problem (48 x 90,
  f64 G, A and W_gen, the f32 grid 0, 0.1, ..., 1, k=5) at (2, 2) and
  (1, 4) (90 items pad to 92 there): ``sharded_lambda_sweep`` grid-parallel
  and with its budget forced to 1 byte (the item-sharded layout with the
  given W_gen and S), ``item_sharded_lambda_sweep`` building W_gen and S as
  collective Grams (duplicate-counting degrees), the grid-parallel sweep
  building them itself, and ``sharded_lambda_sweep_tall``. Each one's rows
  (``sweep_rows``: 5 decimals, F1 of the rounded P and R) equal the port's
  single-device sweep's and JAX's same sharded function's at the same mesh
  shape under x64; the raw metrics within 1e-5 relative
  (``tests/test_sweep.py:178-357``'s bar).
- ``cli/main --mesh 1,2 --device cpu`` on two ranks, for LightGCNOpti and
  SpreadLightGCNOpti on shared checkpoints (``tests/test_torch_main.py``'s
  config): the list file and the JSON metric line identical to
  ``lgcnhs_tpu.cli.main --mesh 1,2``'s; only rank 0 prints the line.
- ``cli/find_lambda --mesh 1,2``: the CSV byte-identical to JAX's.
- ``dryrun_multichip`` runs at 2 ranks and at 4 (a (2, 2) mesh): the
  flagship path, then the graph forced onto the COO route with the tables
  replicated and row-sharded, the two train losses within 2e-5.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lgcnhs_tpu.cli import find_lambda as j_fl
from lgcnhs_tpu.cli import main as j_main
from lgcnhs_tpu.ops import sweep as jsweep
from lgcnhs_tpu.runtime.mesh import make_mesh as j_make_mesh
from lgcnhs_tpu_torch.ops import sweep as tsweep
from lgcnhs_tpu_torch.parallel.dryrun import dryrun_multichip
from test_torch_main import SIZE as MAIN_SIZE
from test_torch_main import _config as main_config
from test_torch_main import _json_line, _write_checkpoints
from test_torch_sweep import DENSE_ARGS, GRID, K, TALL_ARGS, _setup, _size
from test_torch_sweep import _write_checkpoint as _write_sweep_checkpoint
from torch_port_checks import MeshRun

SHAPES = [(2, 2), (1, 4)]
VARIANTS = ["grid", "item", "gram", "grid_built", "tall"]
CLI_MODELS = ["LightGCNOpti", "SpreadLightGCNOpti"]
SWEEP_SIZE = (50, 80, 2000)


@pytest.fixture
def x64():
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """(host arrays, {shape: every rank's outputs})."""
    root = tmp_path_factory.mktemp("mesh_sweep")
    s = _setup(np.float64)
    inputs = {n: np.asarray(s[n]) for n in set(DENSE_ARGS + TALL_ARGS)}
    inputs.update(lambdas=GRID, k=K)
    started = {shape: MeshRun("sweep", shape, inputs, root / f"{shape[0]}x{shape[1]}")
               for shape in SHAPES}
    return s, {shape: run.results() for shape, run in started.items()}


def _jax_rows(variant, s, shape):
    mesh = j_make_mesh(shape)
    a = {n: jnp.asarray(s[n]) for n in set(DENSE_ARGS + TALL_ARGS)}
    dense = [a[n] for n in DENSE_ARGS]
    built = [a["G"], a["A"], None, a["seen"], a["eval_pos"], a["eval_counts"],
             a["eval_present"], None]
    if variant == "grid":
        return jsweep.sharded_lambda_sweep(mesh, GRID, *dense, k=K)
    if variant == "item":
        return jsweep.sharded_lambda_sweep(mesh, GRID, *dense, k=K, memory_budget_bytes=1)
    if variant == "gram":
        return jsweep.item_sharded_lambda_sweep(mesh, GRID, *built, k=K, item_deg=a["item_deg"])
    if variant == "grid_built":
        return jsweep.sharded_lambda_sweep(mesh, GRID, *built, k=K, item_deg=a["item_deg"])
    return jsweep.sharded_lambda_sweep_tall(mesh, GRID, *(a[n] for n in TALL_ARGS), k=K)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_sweep_rows(x64, swept, shape, variant):
    import torch

    s, outs = swept
    got = outs[shape][0][variant]
    for out in outs[shape][1:]:  # every rank gets the whole grid
        np.testing.assert_array_equal(out[variant], got)
    if variant == "tall":
        single = tsweep.lambda_sweep_metrics_tall(
            GRID, *(torch.from_numpy(np.asarray(s[n])) for n in TALL_ARGS), K).numpy()
    else:
        single = tsweep.lambda_sweep_metrics(
            GRID, *(torch.from_numpy(np.asarray(s[n])) for n in DENSE_ARGS), K).numpy()
    want_jax = np.asarray(_jax_rows(variant, s, shape))
    assert got.shape == single.shape == want_jax.shape == (len(GRID), 5)
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=0)
    np.testing.assert_allclose(got, want_jax, rtol=1e-5, atol=0)
    rows = tsweep.sweep_rows(GRID, got)
    assert rows == tsweep.sweep_rows(GRID, single)
    assert rows == jsweep.sweep_rows(GRID, want_jax)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The JAX and port workdirs after both CLIs ran with --mesh 1,2, and the
    port ranks' outputs."""
    root = tmp_path_factory.mktemp("mesh_cli")
    jdir, tdir = str(root / "j"), str(root / "t")
    _write_checkpoints([jdir, tdir], seed=0)
    ljdir, ltdir = str(root / "lj"), str(root / "lt")
    sweep_cfgs = _write_sweep_checkpoint([ljdir, ltdir], *SWEEP_SIZE)
    mesh_args = ["--mesh", "1,2"]
    run = MeshRun("cli", (1, 2), {
        "models": np.asarray(CLI_MODELS),
        "main_args": np.asarray(["--device", "cpu", *mesh_args, "--workdir", tdir, *MAIN_SIZE]),
        "lambda_args": np.asarray([*_size(*SWEEP_SIZE), "--workdir", ltdir, "--step", "0.25",
                                   "--device", "cpu", *mesh_args]),
    }, root / "ranks")
    for model in CLI_MODELS:
        j_main.main(["--platform", "cpu", *mesh_args, "--model", model, "--workdir", jdir,
                     *MAIN_SIZE])
    j_fl.main([*_size(*SWEEP_SIZE), "--workdir", ljdir, "--step", "0.25", *mesh_args])
    return (jdir, tdir, sweep_cfgs), run.results()


def _list(model, workdir):
    return np.load(os.path.join(main_config(model, workdir).recommend_path,
                                f"all_user_recommend_{model}_10.npy"))


@pytest.mark.parametrize("model", CLI_MODELS)
def test_cli_main_on_a_mesh_matches_jax(cli_run, model, capsys):
    (jdir, tdir, _), outs = cli_run
    np.testing.assert_array_equal(_list(model, tdir), _list(model, jdir))
    # JAX's line, printed by the port's rank 0 only
    want = j_main.main(["--platform", "cpu", "--mesh", "1,2", "--model", model,
                        "--workdir", jdir, *MAIN_SIZE])
    want_line = _json_line(capsys.readouterr().out)
    lines = [line for line in str(outs[0]["stdout"]).splitlines()
             if line.startswith('{"model"')]
    got_line = [line for line in lines if json.loads(line)["model"] == model]
    assert got_line == [want_line]
    assert json.loads(want_line) == {"model": model, "k": 10, **want}
    assert '{"model"' not in str(outs[1]["stdout"])


def test_cli_find_lambda_on_a_mesh_matches_jax(cli_run):
    (_, _, sweep_cfgs), _ = cli_run
    paths = [os.path.join(cfg.evaluation_path, f"lambda_evaluation_{cfg.k}.csv")
             for cfg in sweep_cfgs]
    with open(paths[0], "rb") as f:
        want = f.read()
    with open(paths[1], "rb") as f:
        got = f.read()
    assert got == want
    assert got.count(b"\n") == 6  # the header and 5 grid points


def test_dryrun_multichip_runs():
    dryrun_multichip(2)


def test_dryrun_multichip_runs_at_four_ranks():
    dryrun_multichip(4)

"""Lambda hyperparameter sweep.

Port of ``lgcnhs_tpu/cli/find_lambda.py`` (reference ``findLambda.py:49-138``):
load the LightGCNOpti checkpoint (or train it when it is missing) and form
the allocation matrix G once, then evaluate all six metrics of the
SpreadLightGCNOpti lists at every lambda of the grid ``0, step, ..., 1``
(float32, as ``np.arange`` makes it) through ``ops/sweep``. Writes
``lambda_evaluation_<k>.csv`` and, where matplotlib imports, one PNG a
metric, as the JAX CLI does.

Usage:
  python -m lgcnhs_tpu_torch.cli.find_lambda --dataset movielens1m --env prod \\
      --workdir artifacts [--step 0.01] [--device cpu]

The flavor follows the JAX CLI's dispatch (``lgcnhs_tpu/cli/find_lambda.py:
65-130``): the W-free flavor where ``choose_diffusion`` says "factored", or
says "blocked"/"sharded" and the factored live set still fits one device
(with ``--mesh``: the grid over every rank, ``sharded_lambda_sweep_tall``);
the dense flavor otherwise, or with ``--mesh`` ``sharded_lambda_sweep``
(grid-parallel, or item-sharded past its replication budget); without a
mesh, an exit where nothing fits one device. The flavor is picked before G
is trained or loaded. On a mesh every rank sweeps and gets the rows; rank 0
alone writes the CSV and the plots:
  torchrun --nproc-per-node N -m lgcnhs_tpu_torch.cli.find_lambda --mesh 1,N ...
"""
from __future__ import annotations

import os

import numpy as np
import torch

from lgcnhs_tpu_torch.cli.common import (
    base_parser, config_from_args, distributed_run, load_pipeline,
)
from lgcnhs_tpu_torch.data.graph import interaction_matrix, pos_bool_matrix
from lgcnhs_tpu_torch.eval.metrics import EvalContext
from lgcnhs_tpu_torch.models.fusion import allocate_matrix
from lgcnhs_tpu_torch.models.recommenders import get_or_train_params
from lgcnhs_tpu_torch.ops.diffusion import (
    choose_diffusion,
    factored_fits,
    general_spreading_matrix,
)
from lgcnhs_tpu_torch.ops.metrics_ops import similarity_matrix
from lgcnhs_tpu_torch.ops.sweep import (
    lambda_sweep_metrics, lambda_sweep_metrics_tall, sharded_lambda_sweep,
    sharded_lambda_sweep_tall, sweep_rows,
)
from lgcnhs_tpu_torch.runtime.device import resolve_device
from lgcnhs_tpu_torch.runtime.logging import get_logger
from lgcnhs_tpu_torch.runtime.mesh import is_writer, mesh_from_config
from lgcnhs_tpu_torch.runtime.table import rows_to_columns, write_csv

METRICS = ("P", "R", "F1", "NDCG", "H", "I")


def sweep_flavor(n_users: int, n_items: int, mesh: bool = False) -> str:
    """"tall" (no (I, I) operand), "dense", or with a mesh "sharded" where
    the dense flavor would run or nothing fits one device, at f32;
    ``SystemExit`` without a mesh where no single-device layout fits
    (``find_lambda.py:67-113``)."""
    itemsize = 4
    regime = choose_diffusion(n_users, n_items, itemsize)
    # the W-free flavor is exact for any shape (2U < I is only its FLOPs
    # heuristic), so it also takes the blocked/sharded regimes whose
    # factored live set (U^2 + 3 U I) fits
    if regime == "factored" or (regime in ("blocked", "sharded")
                                and factored_fits(n_users, n_items, itemsize)):
        return "tall"
    if mesh:
        return "sharded"
    if regime in ("blocked", "sharded"):
        raise SystemExit(
            f"lambda sweep at U={n_users} x I={n_items} exceeds a single device in every "
            "layout (the (I, I) operands and the W-free flavor's (U, U) + (U, I) live set "
            "are all over budget) — run with --mesh to use the item-sharded sweep"
        )
    return "dense"


def _plot(rows, out_dir: str, k: int, log) -> None:
    """One PNG a metric against lambda, where matplotlib imports."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        log.info("matplotlib not installed: lambda curves not plotted")
        return
    try:
        lams = [row["lambda"] for row in rows]
        for metric in METRICS:
            fig = plt.figure()
            plt.plot(lams, [row[metric] for row in rows])
            plt.xlabel("lambda")
            plt.ylabel(metric)
            plt.title(f"{metric} curves")
            plt.savefig(os.path.join(out_dir, f"{metric}_{k}.png"))
            plt.close(fig)
    except Exception as exc:  # plotting must never lose the sweep
        log.warning("plotting failed: %s", exc)


def main(argv=None) -> list:
    parser = base_parser(__doc__)
    parser.add_argument("--step", type=float, default=0.01, help="lambda grid step")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    with distributed_run(cfg, device):
        return _run(args, cfg, device)


def _run(args, cfg, device) -> list:
    log = get_logger("lgcnhs", cfg.log_path)
    mesh = mesh_from_config(cfg.compute)
    graph, user_features, item_features, _ = load_pipeline(cfg, device)
    U, I = graph.n_users, graph.n_items
    flavor = sweep_flavor(U, I, mesh is not None)
    ctx = EvalContext.build(U, I, graph.test, graph.train, graph.val, device)

    # G once (findLambda.py:79)
    params = get_or_train_params(graph, cfg, device, user_features, item_features)
    A = torch.from_numpy(interaction_matrix(U, I, graph.train, graph.val)).to(device)
    seen = torch.from_numpy(pos_bool_matrix(U, I, graph.train, graph.val)).to(device)
    G = allocate_matrix(params, seen)
    lambdas = np.arange(0.0, 1.0 + args.step, args.step, dtype=np.float32)
    eval_args = (ctx.on_device(ctx.eval_pos), ctx.on_device(ctx.eval_counts),
                 ctx.on_device(ctx.eval_present))
    item_deg = ctx.on_device(ctx.item_deg)

    if flavor == "tall":
        where = f"grid over the {mesh.size} ranks of mesh {mesh.shape}" if mesh else str(device)
        log.info("lambda sweep: W-free flavor (no (I, I) operand; user-factored "
                 "diffusion + direct Sorensen), %d points on %s", len(lambdas), where)
        tall_args = (G, A, seen, *eval_args, item_deg)
        if mesh is not None:
            metrics = sharded_lambda_sweep_tall(mesh, lambdas, *tall_args, k=cfg.k)
        else:
            metrics = lambda_sweep_metrics_tall(lambdas, *tall_args, cfg.k)
    elif flavor == "sharded":
        # W_gen and S are built inside, in the layout the replication budget
        # picks: whole on every rank, or as collective Grams over the
        # item-sharded A where a whole (I, I) would not fit a rank
        log.info("lambda sweep sharded over %d ranks (mesh %s flattened), %d points",
                 mesh.size, mesh.shape, len(lambdas))
        metrics = sharded_lambda_sweep(mesh, lambdas, G, A, None, seen, *eval_args, None,
                                       k=cfg.k, item_deg=item_deg)
    else:
        log.info("lambda sweep: dense flavor (W_gen and S hoisted), %d points on %s",
                 len(lambdas), device)
        # W_gen once (findLambda.py:81)
        W_gen = general_spreading_matrix(A)
        S = similarity_matrix(ctx.on_device(ctx.interaction), item_deg)
        metrics = lambda_sweep_metrics(lambdas, G, A, W_gen, seen, *eval_args, S, cfg.k)

    rows = sweep_rows(lambdas, metrics.cpu().numpy())
    for row in rows:
        log.info("lambda %.2f evaluated: %s", row["lambda"], row)
    if is_writer():
        out = os.path.join(cfg.evaluation_path, f"lambda_evaluation_{cfg.k}.csv")
        write_csv(out, rows_to_columns(rows))
        log.info("lambda sweep saved: %s", out)
        _plot(rows, cfg.evaluation_path, cfg.k, log)
    return rows


if __name__ == "__main__":
    main()

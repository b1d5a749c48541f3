"""Shared CLI plumbing: argument parsing, config, device and pipeline
assembly.

Port of ``base_parser``, ``config_from_args`` and ``load_pipeline`` in
``lgcnhs_tpu/cli/common.py``. ``--device`` picks the card (default) or the
CPU; ``--no-cache`` makes ``cli/main`` ignore its cached lists
(``runtime/cache.ArtifactCache``). Flags left out, and why:

- ``--platform``, ``--profile``, ``--scan-chunk``: JAX-only (the platform
  pin, ``jax.profiler``, the ``lax.scan`` chunking);
- ``--mesh``, ``--coo-table-sharding``: the mesh is ROADMAP queue 1 item 7;
- ``--data-dir``, ``--fetch``: raw-data ingestion is ROADMAP queue 1 item 5.
"""
from __future__ import annotations

import argparse

import torch

from lgcnhs_tpu_torch.config import DATASETS, MODEL_NAMES, Config, load_config
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.data.graph import build_graph
from lgcnhs_tpu_torch.runtime.logging import get_logger


def base_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--env", choices=["dev", "prod"], default="dev")
    p.add_argument("--dataset", choices=list(DATASETS), default="movielens")
    p.add_argument("--model", choices=list(MODEL_NAMES), default="SpreadLightGCNOpti")
    p.add_argument("--workdir", default="artifacts")
    p.add_argument("--k", type=int, default=None, help="recommendation list size")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lambda", dest="lambda_", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--users", type=int, default=None, help="synthetic user count")
    p.add_argument("--items", type=int, default=None, help="synthetic item count")
    p.add_argument(
        "--interactions", type=int, default=None, help="synthetic interaction count"
    )
    p.add_argument(
        "--quantile",
        type=float,
        nargs=2,
        default=None,
        metavar=("START", "END"),
        help="override the user-activity quantile band filter "
        "(reference handleData.py:39-57; '--quantile 1 0' disables filtering)",
    )
    p.add_argument(
        "--dtype",
        choices=["float32", "bfloat16"],
        default=None,
        help="compute dtype: float32 = the exact parity path (dev default), "
        "bfloat16 = mixed precision (bf16 propagation inputs, f32 tables and "
        "optimizer; prod default; on CUDA it trains through the dual_matmul kernel)",
    )
    p.add_argument(
        "--neg-range",
        choices=["catalog", "reference"],
        default=None,
        help="BPR negative-candidate range: 'catalog' (default, uniform over all "
        "items) or 'reference' to reproduce torch-geometric's "
        "structured_negative_sampling bound (max node id present in the split, "
        "model/LightGCN/loss.py:58; docs/PARITY.md deviations #6)",
    )
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="run on the CUDA card (default; raises without one) or on the CPU",
    )
    p.add_argument("--no-cache", action="store_true", help="ignore cached artifacts")
    return p


def config_from_args(args: argparse.Namespace) -> Config:
    # f32 matmuls run in full f32 (ROADMAP "Precision"): TF32 keeps ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    overrides = {}
    if args.k is not None:
        overrides["k"] = args.k
    if args.epochs is not None:
        overrides["hparams.epochs"] = args.epochs
    if args.lambda_ is not None:
        overrides["hparams.lambda_"] = args.lambda_
    if args.batch_size is not None:
        overrides["hparams.batch_size"] = args.batch_size
    if args.users is not None:
        overrides["synthetic_users"] = args.users
    if args.items is not None:
        overrides["synthetic_items"] = args.items
    if args.interactions is not None:
        overrides["synthetic_interactions"] = args.interactions
    if args.neg_range is not None:
        overrides["hparams.neg_range"] = args.neg_range
    if args.dtype is not None:
        overrides["compute.dtype"] = args.dtype
    if args.quantile is not None:
        overrides["preprocessing.quantile_start"] = args.quantile[0]
        overrides["preprocessing.quantile_end"] = args.quantile[1]
    cfg = load_config(
        env=args.env,
        dataset=args.dataset,
        model=args.model,
        workdir=args.workdir,
        overrides=overrides,
    )
    cfg.ensure_dirs()
    return cfg


def load_pipeline(cfg: Config):
    """Dataset -> (graph arrays, user features, item features, splits), with
    the JAX package's shape log line (reference ``main.py:47-58``)."""
    log = get_logger("lgcnhs", cfg.log_path)
    splits, user_features, item_features = load_dataset(cfg)
    graph = build_graph(splits)
    log.info(
        "users: %d, items: %d | train %s val %s test %s | user_features %s item_features %s",
        graph.n_users,
        graph.n_items,
        graph.train.n_edges,
        graph.val.n_edges,
        graph.test.n_edges,
        user_features.shape,
        item_features.shape,
    )
    return graph, user_features, item_features, splits

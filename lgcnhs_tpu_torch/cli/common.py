"""Shared CLI plumbing: argument parsing, config and device.

Port of ``base_parser`` / ``config_from_args`` in
``lgcnhs_tpu/cli/common.py``. The JAX-only flags (platform, mesh, fetch,
scan chunking, COO table sharding, profiling) have no counterpart; flags of
stages not ported yet (raw-data ingestion, artifact cache) arrive with
those stages. ``--device`` picks the card (default) or the CPU.
"""
from __future__ import annotations

import argparse

import torch

from lgcnhs_tpu_torch.config import DATASETS, MODEL_NAMES, Config, load_config


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

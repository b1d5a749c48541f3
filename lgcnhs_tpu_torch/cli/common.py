"""Shared CLI plumbing: argument parsing, config and device.

Port of ``base_parser`` / ``config_from_args`` in
``lgcnhs_tpu/cli/common.py``. The JAX-only flags (platform, mesh, fetch,
scan chunking, COO table sharding, profiling) have no counterpart; flags of
stages not ported yet (training, raw-data ingestion, artifact cache) arrive
with those stages. ``--device`` picks the card (default) or the CPU.
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
    p.add_argument("--lambda", dest="lambda_", type=float, default=None)
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
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="run on the CUDA card (default; raises without one) or on the CPU",
    )
    return p


def resolve_device(name: str) -> torch.device:
    """``cuda`` unless the CPU is asked for; never falls back silently."""
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass --device cpu (device='cpu') to run on the CPU"
        )
    return torch.device(name)


def config_from_args(args: argparse.Namespace) -> Config:
    # f32 matmuls run in full f32 (ROADMAP "Precision"): TF32 keeps ~3 digits
    torch.backends.cuda.matmul.allow_tf32 = False
    overrides = {}
    if args.k is not None:
        overrides["k"] = args.k
    if args.lambda_ is not None:
        overrides["hparams.lambda_"] = args.lambda_
    if args.users is not None:
        overrides["synthetic_users"] = args.users
    if args.items is not None:
        overrides["synthetic_items"] = args.items
    if args.interactions is not None:
        overrides["synthetic_interactions"] = args.interactions
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

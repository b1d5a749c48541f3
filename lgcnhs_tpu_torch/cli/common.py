"""Shared CLI plumbing: argument parsing, config, device and pipeline
assembly.

Port of ``base_parser``, ``config_from_args`` and ``load_pipeline`` in
``lgcnhs_tpu/cli/common.py``. ``--device`` picks the card (default) or the
CPU, for the run and for ingestion's text embedder; ``--data-dir`` points
at a directory of raw dataset files (ingested by ``data/datasets.py``),
``--fetch`` downloads ML-100K / ML-1M there when asked (``data/fetch.py``);
``--no-cache`` makes ``cli/main`` ignore its cached lists
(``runtime/cache.ArtifactCache``). ``--mesh DATA,MODEL|auto`` sets
``compute.mesh_shape``: run one process a device under ``torchrun``
(``torchrun --nproc-per-node N -m lgcnhs_tpu_torch.cli.main --mesh 1,N``;
with ``--device cpu`` the ranks are CPU processes on gloo);
``distributed_run`` starts and ends the process group, and
``load_pipeline`` loads the data on rank 0 and hands it to the others.
``--coo-table-sharding`` row-shards the tables on a mesh that trains a
graph on the COO route. ``--profile DIR`` makes ``cli/main`` record a
``torch.profiler`` trace (``runtime/logging.profile_trace``).
``--scan-chunk N`` sets ``compute.scan_chunk``, the most epochs one
captured CUDA graph of the trainer holds (``train/trainer.TrainScan``).
Flag left out: ``--platform`` (``--device`` plays its part).
"""
from __future__ import annotations

import argparse
import contextlib
import os
from typing import Iterator

import torch
import torch.distributed as dist

from lgcnhs_tpu_torch.config import DATASETS, MODEL_NAMES, Config, load_config
from lgcnhs_tpu_torch.data.datasets import load_dataset
from lgcnhs_tpu_torch.data.graph import build_graph
from lgcnhs_tpu_torch.runtime.logging import get_logger
from lgcnhs_tpu_torch.runtime.mesh import init_distributed, world_size


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
        "--mesh",
        default=None,
        metavar="DATA,MODEL",
        help='device mesh shape, e.g. "2,4", or "auto" to put every rank on the model '
        "axis (tables row-sharded, catalog item-sharded, distributed top-k; default "
        "single device); one process a device, started by torchrun",
    )
    p.add_argument(
        "--data-dir",
        default=None,
        metavar="DIR",
        help="directory holding the raw dataset files (e.g. an extracted "
        "ml-100k/); sets preprocessing.dataset_paths",
    )
    p.add_argument(
        "--fetch",
        action="store_true",
        help="opt-in: download the dataset (ML-100K ~5 MB / ML-1M ~6 MB, "
        "files.grouplens.org, md5-verified) into <workdir>/data when the raw "
        "files are absent; logged no-op without network egress",
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
        "--scan-chunk",
        type=int,
        default=None,
        metavar="N",
        help="max epochs per device program (bounds single-execution "
        "wall-clock on relayed TPUs; chunking never changes the model — "
        "the per-epoch fold_in key stream is dispatch-invariant)",
    )
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="run on the CUDA card (default; raises without one) or on the CPU",
    )
    p.add_argument(
        "--coo-table-sharding",
        action="store_true",
        help="mesh x COO regime: row-shard the embedding tables + optimizer state over the "
        "model axis (~1/n_model persistent table bytes per device) instead of replicating; "
        "minibatch rows exchanged shard-by-shard. Requires --mesh and a graph on the COO path",
    )
    p.add_argument("--no-cache", action="store_true", help="ignore cached artifacts")
    p.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="record a torch.profiler trace of the run into DIR "
        "(TensorBoard's *.pt.trace.json, one file a rank; the port's spans, "
        "train.* and serve.*, are ranges in it)",
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
    if args.scan_chunk is not None:
        overrides["compute.scan_chunk"] = args.scan_chunk
    if args.neg_range is not None:
        overrides["hparams.neg_range"] = args.neg_range
    if args.dtype is not None:
        overrides["compute.dtype"] = args.dtype
    if args.coo_table_sharding:
        overrides["compute.coo_table_sharding"] = True
    if args.quantile is not None:
        overrides["preprocessing.quantile_start"] = args.quantile[0]
        overrides["preprocessing.quantile_end"] = args.quantile[1]
    if args.mesh is not None:
        if args.mesh == "auto":
            overrides["compute.mesh_shape"] = (0, 0)  # every rank on the model axis
        else:
            parts = tuple(int(x) for x in args.mesh.split(","))
            if len(parts) != 2 or any(p < 1 for p in parts):
                raise SystemExit(f"--mesh expects DATA,MODEL (got {args.mesh!r})")
            overrides["compute.mesh_shape"] = parts
    if args.data_dir:
        from lgcnhs_tpu_torch.data.fetch import douban_paths, ml100k_paths, ml1m_paths

        path_fn = {
            "movielens1m": ml1m_paths,
            "douban": douban_paths,
        }.get(args.dataset, ml100k_paths)
        overrides["preprocessing.dataset_paths"] = path_fn(args.data_dir)
    elif args.fetch and args.dataset in ("movielens", "movielens1m"):
        from lgcnhs_tpu_torch.data.fetch import fetch_ml100k, fetch_ml1m

        fetch_fn = fetch_ml1m if args.dataset == "movielens1m" else fetch_ml100k
        paths = fetch_fn(os.path.join(args.workdir, "data"))
        if paths is not None:
            overrides["preprocessing.dataset_paths"] = paths
    cfg = load_config(
        env=args.env,
        dataset=args.dataset,
        model=args.model,
        workdir=args.workdir,
        overrides=overrides,
    )
    cfg.ensure_dirs()
    return cfg


@contextlib.contextmanager
def distributed_run(cfg: Config, device: torch.device) -> Iterator[int]:
    """The process group a mesh run needs, for the body of an entry point:
    started (``runtime/mesh.init_distributed``, from the variables torchrun
    sets; NCCL on CUDA, gloo on the CPU) when ``compute.mesh_shape`` needs
    more than one rank, or is "auto" under a launcher of several, and ended
    on the way out. A group the caller already started is kept and left
    running. Yields the world size."""
    shape = tuple(cfg.compute.mesh_shape)
    started = False
    if not dist.is_initialized() and (
        shape[0] * shape[1] > 1 or (shape == (0, 0) and int(os.environ.get("WORLD_SIZE", "1")) > 1)
    ):
        started = init_distributed(device=device) > 1
    try:
        yield world_size()
    finally:
        if started:
            dist.destroy_process_group()


def load_pipeline(cfg: Config, device="cuda"):
    """Dataset -> (graph arrays, user features, item features, splits), with
    the JAX package's shape log line (reference ``main.py:47-58``).
    ``splits`` carries the raw<->internal id mappings for external-id decode;
    ``device`` trains ingestion's text embedder. Under a process group rank
    0 alone loads (and writes the preprocessing artifacts) and the other
    ranks receive its arrays."""
    log = get_logger("lgcnhs", cfg.log_path)
    if world_size() > 1:
        loaded = [load_dataset(cfg, device) if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(loaded, src=0)
        splits, user_features, item_features = loaded[0]
    else:
        splits, user_features, item_features = load_dataset(cfg, device)
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

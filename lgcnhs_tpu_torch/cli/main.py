"""End-to-end recommendation pipeline (the main entry point).

Port of ``lgcnhs_tpu/cli/main.py`` (reference ``main.py:25-106``): Step 1
loads the data, Step 2 loads the cached (U, k) lists of the model or
computes them (``models.recommenders.recommend``: the spread models'
diffusion, LightGCN[Opti] retrieval, SpreadLightGCN[Opti]'s fused ranker;
a missing checkpoint is trained first), Step 3 evaluates the six metrics
on the test split and prints them as one JSON line.

Usage:
  python -m lgcnhs_tpu_torch.cli.main --dataset movielens1m --env prod \\
      --model SpreadLightGCNOpti --workdir artifacts [--data-dir DIR] \\
      [--no-cache] [--device cpu]

``--profile DIR`` records a ``torch.profiler`` trace of the run (the host,
and the card on CUDA) into DIR, one ``*.pt.trace.json`` a rank; the
program's spans (``runtime/logging.span``: the trainer's ``train.*``,
``serve_fused``'s ``serve.*``) are named ranges in it.

``--target-user`` logs one user's list by RAW dataset id (a Douban md5 or a
MovieLens id, tried as given and then as an int), decoded through the id
mappings (``data/idmap.py``); ``--target-user-internal`` takes the internal
index.

On a mesh, one process a device:
  torchrun --nproc-per-node N -m lgcnhs_tpu_torch.cli.main --mesh 1,N ...
(``--device cpu``: N CPU processes on gloo). Every rank runs the pipeline
(training, the item-sharded ranking and the evaluation); rank 0 alone
writes the artifacts and the log file and prints the metric line. A graph
on the COO route trains with its edge list sharded over the ranks;
``--coo-table-sharding`` also row-shards its tables and Adam's state.
"""
from __future__ import annotations

import json

from lgcnhs_tpu_torch.cli.common import (
    base_parser, config_from_args, distributed_run, load_pipeline,
)
from lgcnhs_tpu_torch.data.idmap import IdMapper
from lgcnhs_tpu_torch.eval.metrics import EvalContext, evaluate_recommendations
from lgcnhs_tpu_torch.models.recommenders import recommend
from lgcnhs_tpu_torch.runtime.cache import ArtifactCache
from lgcnhs_tpu_torch.runtime.device import resolve_device
from lgcnhs_tpu_torch.runtime.logging import get_logger, profile_trace
from lgcnhs_tpu_torch.runtime.mesh import barrier, is_writer


def main(argv=None) -> dict:
    parser = base_parser(__doc__)
    parser.add_argument(
        "--target-user",
        default=None,
        help="also log this user's recommendation list, by RAW dataset id "
        "— a Douban nickname-md5 or a raw MovieLens id — decoded through "
        "the stored id mappings (the reference configures target_user as a "
        "raw md5, const.py:244; handleRating's uid_mapping, "
        "processing/handleData.py:70-77)",
    )
    parser.add_argument(
        "--target-user-internal",
        type=int,
        default=None,
        help="also log this user's recommendation list, by INTERNAL dense index",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    with distributed_run(cfg, device), profile_trace(args.profile, device):
        return _run(args, cfg, device)


def _run(args, cfg, device) -> dict:
    log = get_logger("lgcnhs", cfg.log_path)

    log.info("Step1: loading preprocessed data")
    graph, user_features, item_features, splits = load_pipeline(cfg, device)

    log.info("Step2: computing recommendations with model %s", cfg.model)
    cache = ArtifactCache(cfg.recommend_path, enabled=not args.no_cache)
    rec_key = f"all_user_recommend_{cfg.model}_{cfg.k}"
    rec = cache.load_recommendations(rec_key)
    barrier()  # every rank has read the cache before rank 0 may write it
    if rec is None or rec.shape != (graph.n_users, cfg.k):
        rec = recommend(graph, cfg, device, user_features, item_features)
        if is_writer():
            cache.save_recommendations(rec_key, rec)
    else:
        log.info("loaded cached recommendations: %s", rec_key)

    log.info("Step3: evaluating recommendations on the test split")
    ctx = EvalContext.build(graph.n_users, graph.n_items, graph.test, graph.train, graph.val,
                            device)
    metrics = evaluate_recommendations(ctx, rec)
    log.info(
        "[%s Test Accurate] precision@%d: %s, recall@%d: %s, f1@%d: %s, NDCG@%d: %s",
        cfg.model, cfg.k, metrics["P"], cfg.k, metrics["R"], cfg.k, metrics["F1"],
        cfg.k, metrics["NDCG"],
    )
    log.info(
        "[%s Test Diversity] H@%d: %s, I@%d: %s",
        cfg.model, cfg.k, metrics["H"], cfg.k, metrics["I"],
    )
    if args.target_user is not None or args.target_user_internal is not None:
        _log_target_user(args, graph, splits, rec, log)
    if is_writer():
        print(json.dumps({"model": cfg.model, "k": cfg.k, **metrics}))
    return metrics


def _log_target_user(args, graph, splits, rec, log) -> None:
    """One user's list, by raw id decoded through the id mappings or by
    internal index (``lgcnhs_tpu/cli/main.py:77-125``; the port's splits
    always carry their mappings, so JAX's branch for a split cache without
    them has no counterpart)."""
    mapper = IdMapper.from_splits(splits)
    if args.target_user_internal is not None:
        internal = args.target_user_internal
    else:
        # raw id lookup: exact key first (douban md5 strings), then the int
        # form (MovieLens raw ids round-trip argv as str)
        internal = mapper.uid_to_internal.get(args.target_user)
        if internal is None:
            try:
                internal = mapper.uid_to_internal.get(int(args.target_user))
            except ValueError:
                internal = None
    if internal is None or not 0 <= int(internal) < graph.n_users:
        log.warning(
            "target user %r not found in the id mapping (%d users)",
            args.target_user
            if args.target_user is not None
            else args.target_user_internal,
            graph.n_users,
        )
        return
    internal = int(internal)
    raw_items = [mapper.internal_to_iid[i] for i in rec[internal]]
    log.info(
        "recommendations for user %s (internal %d): internal %s, raw %s",
        mapper.internal_to_uid[internal], internal,
        rec[internal].tolist(), raw_items,
    )


if __name__ == "__main__":
    main()

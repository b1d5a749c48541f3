"""End-to-end recommendation pipeline (the main entry point).

Port of ``lgcnhs_tpu/cli/main.py`` (reference ``main.py:25-106``): Step 1
loads the data, Step 2 loads the cached (U, k) lists of the model or
computes them (``models.recommenders.recommend``: the spread models'
diffusion, LightGCN[Opti] retrieval, SpreadLightGCN[Opti]'s fused ranker;
a missing checkpoint is trained first), Step 3 evaluates the six metrics
on the test split and prints them as one JSON line.

Usage:
  python -m lgcnhs_tpu_torch.cli.main --dataset movielens1m --env prod \\
      --model SpreadLightGCNOpti --workdir artifacts [--no-cache] [--device cpu]

``--target-user`` (a raw dataset id) needs the id mappings of
``data/idmap.py``, which are not ported yet (ROADMAP queue 1 item 5);
``--target-user-internal`` takes the internal index.
"""
from __future__ import annotations

import json

from lgcnhs_tpu_torch.cli.common import base_parser, config_from_args, load_pipeline
from lgcnhs_tpu_torch.eval.metrics import EvalContext, evaluate_recommendations
from lgcnhs_tpu_torch.models.recommenders import recommend
from lgcnhs_tpu_torch.runtime.cache import ArtifactCache
from lgcnhs_tpu_torch.runtime.device import resolve_device
from lgcnhs_tpu_torch.runtime.logging import get_logger


def main(argv=None) -> dict:
    parser = base_parser(__doc__)
    parser.add_argument(
        "--target-user",
        default=None,
        help="a user's RAW dataset id; not ported yet (needs data/idmap.py, "
        "ROADMAP queue 1 item 5): use --target-user-internal",
    )
    parser.add_argument(
        "--target-user-internal",
        type=int,
        default=None,
        help="also log this user's recommendation list, by INTERNAL dense index",
    )
    args = parser.parse_args(argv)
    if args.target_user is not None:
        raise SystemExit(
            "--target-user decodes raw ids through data/idmap.py, which is not "
            "ported to lgcnhs_tpu_torch yet (ROADMAP queue 1 item 5); pass "
            "--target-user-internal with the internal index"
        )
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    log = get_logger("lgcnhs", cfg.log_path)

    log.info("Step1: loading preprocessed data")
    graph, user_features, item_features, _ = load_pipeline(cfg)

    log.info("Step2: computing recommendations with model %s", cfg.model)
    cache = ArtifactCache(cfg.recommend_path, enabled=not args.no_cache)
    rec_key = f"all_user_recommend_{cfg.model}_{cfg.k}"
    rec = cache.load_recommendations(rec_key)
    if rec is None or rec.shape != (graph.n_users, cfg.k):
        rec = recommend(graph, cfg, device, user_features, item_features)
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
    user = args.target_user_internal
    if user is not None:
        if 0 <= user < graph.n_users:
            log.info("recommendations for internal user %d: %s", user, rec[user].tolist())
        else:
            log.warning("target user %d is not an internal index (%d users)",
                        user, graph.n_users)
    print(json.dumps({"model": cfg.model, "k": cfg.k, **metrics}))
    return metrics


if __name__ == "__main__":
    main()

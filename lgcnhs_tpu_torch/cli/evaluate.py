"""Cross-model evaluation report.

Port of ``lgcnhs_tpu/cli/evaluate.py`` (reference
``evaluationMetrics.py:19-98``): for each k of ``--ks`` and each model of
``--models``, the cached (U, >= k) list that ``cli/main`` wrote is cut to k
and scored on the six metrics, with one ``EvalContext`` on the device for
every pair. A missing list, or one with fewer than k columns, is skipped
with a log line. Writes ``model_evaluation_<k>.csv`` per k and
``model_evaluation_results.xlsx`` (one sheet per k) through the built-in
OOXML writer, the JAX CLI's writer where openpyxl is missing.

Usage:
  python -m lgcnhs_tpu_torch.cli.evaluate --dataset movielens1m --env prod \\
      --workdir artifacts --ks 30 50 100 [--models ...] [--device cpu]
"""
from __future__ import annotations

import os

from lgcnhs_tpu_torch.cli.common import base_parser, config_from_args, load_pipeline
from lgcnhs_tpu_torch.config import MODEL_NAMES
from lgcnhs_tpu_torch.eval.metrics import EvalContext, evaluate_recommendations
from lgcnhs_tpu_torch.runtime.cache import ArtifactCache
from lgcnhs_tpu_torch.runtime.device import resolve_device
from lgcnhs_tpu_torch.runtime.logging import get_logger
from lgcnhs_tpu_torch.runtime.table import rows_to_columns, write_csv
from lgcnhs_tpu_torch.runtime.xlsx import write_xlsx


def main(argv=None) -> dict:
    parser = base_parser(__doc__)
    parser.add_argument(
        "--ks", type=int, nargs="+", default=[30, 50, 100],
        help="recommendation lengths to evaluate (evaluationMetrics.py:45)",
    )
    parser.add_argument("--models", nargs="+", default=list(MODEL_NAMES))
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    log = get_logger("lgcnhs", cfg.log_path)

    graph, _, _, _ = load_pipeline(cfg, device)
    cache = ArtifactCache(cfg.recommend_path)
    # k-independent: built once for every (k, model) pair (the reference
    # rebuilds it per pair, evaluationMetrics.py:63-69)
    ctx = EvalContext.build(graph.n_users, graph.n_items, graph.test, graph.train, graph.val,
                            device)
    sheets = {}
    for k in args.ks:
        rows = []
        for model in args.models:
            rec = cache.load_recommendations(f"all_user_recommend_{model}_{k}")
            if rec is None:
                log.info("no cached recommendations for model=%s k=%d; skipping", model, k)
                continue
            if rec.shape[1] < k:
                log.info("cached recommendations for %s have only %d < %d columns; skipping",
                         model, rec.shape[1], k)
                continue
            metrics = evaluate_recommendations(ctx, rec[:, :k])
            rows.append({"Model": model, **metrics})
            log.info("k=%d model=%s: %s", k, model, metrics)
        if rows:
            write_csv(os.path.join(cfg.evaluation_path, f"model_evaluation_{k}.csv"),
                      rows_to_columns(rows))
            sheets[k] = rows

    # the reference's workbook (evaluationMetrics.py:94-96)
    if sheets:
        xlsx_path = os.path.join(cfg.evaluation_path, "model_evaluation_results.xlsx")
        write_xlsx(xlsx_path, {str(k): [list(rows[0])] + [list(r.values()) for r in rows]
                               for k, rows in sheets.items()})
        log.info("wrote %s with the built-in xlsx writer", xlsx_path)
    return sheets


if __name__ == "__main__":
    main()

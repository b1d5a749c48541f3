"""BASELINE section-6 parity report: reference pipeline vs the port, one table.

Port of ``lgcnhs_tpu/cli/parity_report.py``. ``BASELINE.md``'s binding
protocol is self-measured: run the reference pipeline on a dataset with its
fixed seeds and record P/R/F1/NDCG/H/I@k per model, then match. This CLI
executes that protocol for the training-free SpreadMethod family
(deterministic given the split, so the parity promise is EXACT): for each
method in {ProbS, HeatS, HybridS} and each k it runs

- the REFERENCE'S OWN ``recommendSpreadMethod`` + ``recommendForAllUser`` +
  ``getAccurateMetrics``/``getDiversityMetrics``
  (``model/SpreadMethod/recommend.py:58-115``, ``metrics/*.py``: the actual
  code, loaded from the reference checkout by ``eval/reference_runner.py``),
  and
- the port's ``models.spread.recommend_spread_method`` + ``eval.metrics`` on
  ``--device``, at float64: the reference's numpy doubles, where f32 ties
  would flip the ranking (the JAX CLI switches x64 on for this),

on the SAME split, and emits a side-by-side table: per (method, k) each
metric of both, ``match`` (all six within 1e-9), ``rec_identical`` and
``tie_equivalent`` (the two lists' f64 scores equal at every rank).
``all_match`` holds when every cell matches or is tie-equivalent.

Without the reference checkout it logs a warning, prints
``{"reference": false}`` and returns. The reference's functions take
DataFrames, so ``_reference_metrics`` imports pandas, inside itself only: the
port's one pandas import, made only on a machine that holds the reference
(and so its requirements).

Output: ``parity_report_<k>.csv`` per k under the evaluation dir
(``runtime/table.write_csv``, byte-identical to pandas'
``to_csv(index=False)``), ``parity_report.md`` (pipe tables with pandas'
``to_markdown`` header and cells, ``runtime/table.to_markdown``), and the
JAX CLI's JSON summary line on stdout.

Usage:
  python -m lgcnhs_tpu_torch.cli.parity_report --dataset movielens1m \\
      --env prod --ks 10 30 [--device cpu]
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

from lgcnhs_tpu_torch.cli.common import base_parser, config_from_args, load_pipeline
from lgcnhs_tpu_torch.config import _lambda_for
from lgcnhs_tpu_torch.eval.metrics import EvalContext, evaluate_recommendations
from lgcnhs_tpu_torch.eval.reference_runner import (
    REF_ROOT, ReferenceModules, reference_available,
)
from lgcnhs_tpu_torch.models.spread import (
    SPREAD_METHODS, recommend_spread_method, spread_scores,
)
from lgcnhs_tpu_torch.runtime.device import resolve_device
from lgcnhs_tpu_torch.runtime.logging import get_logger
from lgcnhs_tpu_torch.runtime.table import rows_to_columns, to_markdown, write_csv

METRIC_KEYS = ("P", "R", "F1", "NDCG", "H", "I")


def _reference_metrics(ref, graph, dataset: str, method: str, lam: float, k: int):
    """One (method, k) cell measured on the reference's own code, which takes
    DataFrames: pandas is imported here, and nowhere else in the port."""
    import pandas as pd

    train_df = pd.DataFrame(
        {"user_id": graph.train.users, "item_id": graph.train.items}
    )
    val_df = pd.DataFrame({"user_id": graph.val.users, "item_id": graph.val.items})
    test_df = pd.DataFrame({"user_id": graph.test.users, "item_id": graph.test.items})

    # movielens1m inherits the movielens quirks on OUR side
    # (models/spread.resolve_spread_variant); give the reference the same
    # DATA_SET string a reference user would set for the ml-1m files
    ref.cfg.DATA_SET = "movielens" if dataset == "movielens1m" else dataset
    # MODEL["name"] drives the ProbS-on-movielens skip-filter quirk
    # (model/SpreadMethod/recommend.py:48-50)
    ref.cfg.MODEL["name"] = method
    ref.cfg.MODEL["HyperParameter"]["lambda"] = lam
    ref.cfg.RECOMMEND["k"] = k
    rec_dict = ref.spread_rec.recommendSpreadMethod(
        graph.n_users, graph.n_items, train_df, val_df, method
    )
    rec = ref.trans.recommendDictToTensor(rec_dict)

    test_pos = ref.trans.getUserItemsDictByDataframe(test_df)
    train_pos = ref.trans.getUserItemsDictByDataframe(train_df)
    val_pos = ref.trans.getUserItemsDictByDataframe(val_df)
    item_deg = ref.trans.getItemDegreeByUserPosItemDict(train_pos, val_pos)
    A = ref.trans.getInteractionMatrixByDataframe(
        graph.n_users, graph.n_items, pd.concat([train_df, val_df])
    )
    p, r, f1, n = ref.accurate.getAccurateMetrics(test_pos, rec, k)
    h, i = ref.diversity.getDiversityMetrics(rec, item_deg, A, k)
    return {"P": p, "R": r, "F1": f1, "NDCG": n, "H": h, "I": i}, np.asarray(rec)


def main(argv=None) -> dict:
    parser = base_parser(__doc__)
    parser.add_argument("--ks", type=int, nargs="+", default=[10, 30])
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    log = get_logger("lgcnhs", cfg.log_path)
    # the reference's numpy double arithmetic on the diffusion chain, where
    # f32-resolution ties would flip the ranking
    cfg = cfg.replace(compute=dataclasses.replace(cfg.compute, dtype="float64"))

    if not reference_available():
        log.warning("no reference checkout at %s; nothing to diff against", REF_ROOT)
        print(json.dumps({"reference": False}))
        return {"reference": False}

    graph, _, _, _ = load_pipeline(cfg, device)
    ctx = EvalContext.build(graph.n_users, graph.n_items, graph.test, graph.train, graph.val,
                            device)
    A = ctx.on_device(ctx.interaction.astype(np.float64))
    u_idx = np.arange(graph.n_users)[:, None]

    sheets = {}
    all_match = True
    with tempfile.TemporaryDirectory() as td, ReferenceModules(td) as ref:
        for k in args.ks:
            rows = []
            for method in SPREAD_METHODS:
                lam = _lambda_for(method, cfg.env)
                cfg_mk = cfg.replace(
                    k=k, model=method,
                    hparams=dataclasses.replace(cfg.hparams, lambda_=lam),
                )

                ours_rec = recommend_spread_method(graph, cfg_mk, device, method)[:, :k]
                ours = evaluate_recommendations(ctx, ours_rec)
                theirs, ref_rec = _reference_metrics(ref, graph, cfg.dataset, method, lam, k)

                row = {"Model": method, "k": k}
                cell_match = True
                for key in METRIC_KEYS:
                    row[f"{key}_ref"] = theirs[key]
                    row[f"{key}_ours"] = ours[key]
                    # both sides round to 5 decimals at their reference-
                    # mandated stages; ties in the unstable reference sort
                    # are the only admissible source of drift
                    cell_match &= abs(float(theirs[key]) - float(ours[key])) <= 1e-9
                row["match"] = bool(cell_match)
                same_shape = ref_rec.shape == ours_rec.shape
                rec_identical = bool(same_shape and (ref_rec == ours_rec).all())
                row["rec_identical"] = rec_identical
                # Tie-equivalence: identical SCORE at every rank. Where lists
                # differ only inside tie groups, the reference's np.argsort
                # quicksort order is implementation-defined
                # (model/SpreadMethod/recommend.py:39): both lists are then
                # equally valid reference outputs and residual metric drift
                # is reference run-to-run variance, not a parity failure.
                tie_equivalent = rec_identical
                if same_shape and not rec_identical:
                    F = spread_scores(A, method, cfg.dataset, lam).cpu().numpy()
                    tie_equivalent = bool((F[u_idx, ref_rec] == F[u_idx, ours_rec]).all())
                row["tie_equivalent"] = tie_equivalent
                all_match &= cell_match or tie_equivalent
                rows.append(row)
                log.info(
                    "k=%d %s: match=%s rec_identical=%s tie_equivalent=%s ours=%s",
                    k, method, row["match"], rec_identical, tie_equivalent, ours,
                )
            sheets[k] = rows_to_columns(rows)

    os.makedirs(cfg.evaluation_path, exist_ok=True)
    md_lines = ["# Parity report (reference code vs lgcnhs_tpu_torch)\n"]
    for k, columns in sheets.items():
        write_csv(os.path.join(cfg.evaluation_path, f"parity_report_{k}.csv"), columns)
        md_lines.append(f"\n## k={k}\n")
        md_lines.append(to_markdown(columns))
    with open(os.path.join(cfg.evaluation_path, "parity_report.md"), "w") as f:
        f.write("\n".join(md_lines) + "\n")

    summary = {
        "reference": True,
        "models": list(SPREAD_METHODS),
        "ks": list(args.ks),
        "all_match": bool(all_match),
        "report": os.path.join(cfg.evaluation_path, "parity_report.md"),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()

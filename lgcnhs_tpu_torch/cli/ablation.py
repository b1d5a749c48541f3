"""Ablation charts: LGCNHS-e (SpreadLightGCN) against LGCNHS
(SpreadLightGCNOpti).

Port of ``lgcnhs_tpu/cli/ablation.py`` (reference ``draw/ablation.ipynb``,
cells 1-4): bar charts of the six metrics of the two fusion variants at each
k of ``--ks``, read from the ``model_evaluation_<k>.csv`` that
``cli/evaluate`` writes (``runtime/table.read_csv``). Charts are drawn
where matplotlib imports; elsewhere a line is logged. No device work.

Usage:
  python -m lgcnhs_tpu_torch.cli.ablation --dataset synthetic --ks 10
"""
from __future__ import annotations

import os

from lgcnhs_tpu_torch.cli.common import base_parser, config_from_args
from lgcnhs_tpu_torch.runtime.logging import get_logger
from lgcnhs_tpu_torch.runtime.table import read_csv

ABLATION_MODELS = {"SpreadLightGCN": "LGCNHS-e", "SpreadLightGCNOpti": "LGCNHS"}
METRICS = ("P", "R", "F1", "NDCG", "H", "I")


def main(argv=None) -> list:
    parser = base_parser(__doc__)
    parser.add_argument("--ks", type=int, nargs="+", default=[30])
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    log = get_logger("lgcnhs", cfg.log_path)

    outputs = []
    for k in args.ks:
        path = os.path.join(cfg.evaluation_path, f"model_evaluation_{k}.csv")
        if not os.path.exists(path):
            log.info("no evaluation CSV for k=%d (%s); run cli.evaluate first", k, path)
            continue
        table = read_csv(path)
        keep = [j for j, model in enumerate(table["Model"]) if model in ABLATION_MODELS]
        if not keep:
            log.info("no fusion-model rows in %s", path)
            continue
        labels = [ABLATION_MODELS[table["Model"][j]] for j in keep]
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            log.info("matplotlib not installed: ablation chart for k=%d not drawn", k)
            continue
        try:
            fig, axes = plt.subplots(1, len(METRICS), figsize=(3 * len(METRICS), 3))
            for ax, metric in zip(axes, METRICS):
                ax.bar(labels, [table[metric][j] for j in keep])
                ax.set_title(f"{metric}@{k}")
                ax.tick_params(axis="x", rotation=20)
            fig.tight_layout()
            out = os.path.join(cfg.evaluation_path, f"ablation_{k}.png")
            fig.savefig(out)
            plt.close(fig)
            outputs.append(out)
            log.info("ablation chart saved: %s", out)
        except Exception as exc:
            log.warning("plotting failed: %s", exc)
    return outputs


if __name__ == "__main__":
    main()

"""Batch retrieval from a trained checkpoint (serving path).

Port of ``lgcnhs_tpu/cli/retrieve.py``: loads a LightGCN[Opti] checkpoint
(the npz either package's trainer writes; trained first, and written, when
it is missing or its shape mismatches), serves every user over the full catalog
with train+val positives masked, and writes the (U, k) recommendation matrix
to ``<workdir>/<dataset>/recommend/retrieval_<model>_<k>.npy``.

- LightGCN / LightGCNOpti: ``ops.topk.retrieve_topk`` (fused retrieval
  kernel on CUDA).
- SpreadLightGCN / SpreadLightGCNOpti: ``models.fusion.serve_fused`` (fused
  LGCNHS serving kernel on CUDA; ``--serve-exact`` takes the plain chain).

Usage:
  python -m lgcnhs_tpu_torch.cli.retrieve --dataset movielens1m --env prod \\
      --model SpreadLightGCNOpti --workdir artifacts [--epochs N] [--device cpu]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from lgcnhs_tpu_torch.cli.common import base_parser, config_from_args, load_pipeline
from lgcnhs_tpu_torch.data.graph import pos_bool_matrix
from lgcnhs_tpu_torch.models.fusion import serve_fused
from lgcnhs_tpu_torch.models.recommenders import get_or_train_params
from lgcnhs_tpu_torch.ops.topk import retrieve_topk
from lgcnhs_tpu_torch.runtime.device import resolve_device
from lgcnhs_tpu_torch.runtime.logging import get_logger


def main(argv=None) -> np.ndarray:
    parser = base_parser(__doc__)
    parser.add_argument(
        "--serve-exact", action="store_true",
        help="fusion models: serve through the plain f32 chain instead of "
        "the fused kernel (the kernel serves any catalog size too)",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    log = get_logger("lgcnhs", cfg.log_path)

    graph, user_features, item_features, _ = load_pipeline(cfg)
    params = get_or_train_params(graph, cfg, device, user_features, item_features)

    if cfg.model in ("SpreadLightGCN", "SpreadLightGCNOpti"):
        rec = serve_fused(graph, cfg, params, exact=args.serve_exact)
    else:
        seen = torch.from_numpy(
            pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
        ).to(device)
        rec = retrieve_topk(params.user_emb, params.item_emb, seen, cfg.k).cpu().numpy()
    out = os.path.join(cfg.recommend_path, f"retrieval_{cfg.model}_{cfg.k}.npy")
    np.save(out, rec)
    log.info("retrieval matrix saved: %s %s", out, rec.shape)
    return rec


if __name__ == "__main__":
    main()

"""Batch retrieval from a trained checkpoint (serving path).

Port of ``lgcnhs_tpu/cli/retrieve.py``: loads a LightGCN[Opti] checkpoint
(the npz either package's trainer writes; trained first, and written, when
it is missing or its shape mismatches), serves every user over the full catalog
with train+val positives masked, and writes the (U, k) recommendation matrix
to ``<workdir>/<dataset>/recommend/retrieval_<model>_<k>.npy``.

- LightGCN / LightGCNOpti: ``models.recommenders.recommend_gcn``, the
  one LightGCN[Opti] serving path (seen set on the card from the edges,
  the fused retrieval kernel on CUDA; chunked past the dense budget,
  sharded with a mesh), where JAX calls ``retrieve_topk`` on a host seen.
- SpreadLightGCN / SpreadLightGCNOpti: ``models.fusion.serve_fused`` (fused
  LGCNHS serving kernel on CUDA; ``--serve-exact`` takes the plain chain).

``--decode`` also writes the raw-id lists through the id mappings
(``data/idmap.py``) to ``retrieval_<model>_<k>.json``, as JAX does.

Usage:
  python -m lgcnhs_tpu_torch.cli.retrieve --dataset movielens1m --env prod \\
      --model SpreadLightGCNOpti --workdir artifacts [--epochs N] [--device cpu]
"""
from __future__ import annotations

import json
import os

import numpy as np

from lgcnhs_tpu_torch.cli.common import base_parser, config_from_args, load_pipeline
from lgcnhs_tpu_torch.data.idmap import IdMapper
from lgcnhs_tpu_torch.models.fusion import serve_fused
from lgcnhs_tpu_torch.models.recommenders import get_or_train_params, recommend_gcn
from lgcnhs_tpu_torch.runtime.device import resolve_device
from lgcnhs_tpu_torch.runtime.logging import get_logger


def main(argv=None) -> np.ndarray:
    parser = base_parser(__doc__)
    parser.add_argument(
        "--decode", action="store_true",
        help="also write raw-id recommendations via the id mapper",
    )
    parser.add_argument(
        "--serve-exact", action="store_true",
        help="fusion models: serve through the plain f32 chain instead of "
        "the fused kernel (the kernel serves any catalog size too)",
    )
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg = config_from_args(args)
    log = get_logger("lgcnhs", cfg.log_path)

    graph, user_features, item_features, splits = load_pipeline(cfg, device)
    params = get_or_train_params(graph, cfg, device, user_features, item_features)

    if cfg.model in ("SpreadLightGCN", "SpreadLightGCNOpti"):
        rec = serve_fused(graph, cfg, params, exact=args.serve_exact)
    else:
        rec = recommend_gcn(graph, cfg, params)
    out = os.path.join(cfg.recommend_path, f"retrieval_{cfg.model}_{cfg.k}.npy")
    np.save(out, rec)
    log.info("retrieval matrix saved: %s %s", out, rec.shape)

    if args.decode:
        decoded = IdMapper.from_splits(splits).decode_recommendations(rec)
        out_json = os.path.join(cfg.recommend_path, f"retrieval_{cfg.model}_{cfg.k}.json")
        with open(out_json, "w") as f:
            json.dump({str(k): [str(i) for i in v] for k, v in decoded.items()}, f)
        log.info("decoded recommendations saved: %s", out_json)
    return rec


if __name__ == "__main__":
    main()

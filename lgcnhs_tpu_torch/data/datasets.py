"""Dataset dispatch: the synthetic tier.

Port of the synthetic branch of ``lgcnhs_tpu/data/datasets.load_dataset``
(``:47-81``): a named dataset whose raw files are absent is synthesized,
seeded, at its configured scale (``movielens1m`` at 6040 x 3706 with
1,000,209 interactions, ``config.py``). Raw-file ingestion is not ported yet.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import numpy as np

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.ratings import RatingSplits, prepare_ratings
from lgcnhs_tpu_torch.data.synthetic import synthesize_features, synthesize_movielens_like
from lgcnhs_tpu_torch.runtime.logging import get_logger

# movielens's true feature widths are 29 (1+7+21) and 37 (19+13+5)
SYN_USER_FEATURE_DIM = 29
SYN_ITEM_FEATURE_DIM = 37


def load_dataset(cfg: Config) -> Tuple[RatingSplits, np.ndarray, np.ndarray]:
    """(splits, user_features, item_features) for the configured dataset."""
    paths = cfg.preprocessing.dataset_paths
    if paths and all(os.path.exists(p) for p in paths.values()):
        raise NotImplementedError(
            f"raw {cfg.dataset} ingestion is not ported yet; only the seeded "
            "synthetic stand-in is"
        )
    if cfg.dataset in ("movielens", "movielens1m", "douban"):
        get_logger().info(
            "%s raw files not found; synthesizing a seeded stand-in dataset",
            cfg.dataset,
        )
    user_col = cfg.preprocessing.columns_map["user_id"]
    item_col = cfg.preprocessing.columns_map["item_id"]
    table = synthesize_movielens_like(
        cfg.synthetic_users,
        cfg.synthetic_items,
        cfg.synthetic_interactions,
        seed=cfg.preprocessing.seed,
        user_col=user_col,
        item_col=item_col,
    )
    # synthetic rating/timestamp column names follow the movielens map
    cfg_syn = cfg.replace(
        preprocessing=dataclasses.replace(
            cfg.preprocessing,
            columns_map={
                "user_id": user_col,
                "item_id": item_col,
                "rating": "rating",
                "rating_time": "timestamp",
            },
        )
    )
    splits = prepare_ratings(table, cfg_syn)
    user_features = synthesize_features(
        splits.n_users, SYN_USER_FEATURE_DIM, cfg.preprocessing.seed
    )
    item_features = synthesize_features(
        splits.n_items, SYN_ITEM_FEATURE_DIM, cfg.preprocessing.seed + 1
    )
    return splits, user_features, item_features

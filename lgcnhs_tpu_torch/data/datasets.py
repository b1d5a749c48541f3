"""Dataset dispatch: raw files, else the synthetic tier.

Port of ``lgcnhs_tpu/data/datasets.load_dataset``. When every raw file of
``preprocessing.dataset_paths`` exists (``--data-dir``), the dataset's own
pipeline ingests it (``data/movielens.py``, ``data/movielens1m.py``,
``data/douban.py``), its text embedder trained on ``device``. Otherwise a
named dataset is synthesized, seeded, at its configured scale
(``movielens1m`` at 6040 x 3706 with 1,000,209 interactions, ``config.py``).
Ingestion writes the rating and feature artifacts to ``cfg.preprocess_path``,
as JAX does; the synthetic tier writes none (JAX writes its rating CSVs too),
since its seed remakes the same split and the four CSVs of an ML-1M-sized
stand-in cost ~2 s of host time a run.
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


def load_dataset(cfg: Config, device="cuda") -> Tuple[RatingSplits, np.ndarray, np.ndarray]:
    """(splits, user_features, item_features) for the configured dataset;
    ``device`` is where ingestion trains its text embedder."""
    save_path = cfg.preprocess_path
    paths = cfg.preprocessing.dataset_paths
    have_raw = bool(paths) and all(os.path.exists(p) for p in paths.values())
    if cfg.dataset == "movielens" and have_raw:
        from lgcnhs_tpu_torch.data.movielens import prepare_movielens

        return prepare_movielens(cfg, save_path, device)
    if cfg.dataset == "movielens1m" and have_raw:
        from lgcnhs_tpu_torch.data.movielens1m import prepare_movielens1m

        return prepare_movielens1m(cfg, save_path, device)
    if cfg.dataset == "douban" and have_raw:
        from lgcnhs_tpu_torch.data.douban import prepare_douban

        return prepare_douban(cfg, save_path, device)

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

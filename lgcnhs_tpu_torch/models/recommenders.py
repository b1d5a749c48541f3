"""Model dispatch: load the cached checkpoint, else train.

Port of ``_embedding_model_name`` and ``get_or_train_params`` in
``lgcnhs_tpu/models/recommenders.py`` (reference
``model/LightGCN/recommend.py:148-154``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.graph import InteractionGraph
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.runtime.logging import get_logger
from lgcnhs_tpu_torch.train.trainer import load_checkpoint, train_lightgcn


def _embedding_model_name(model: str) -> str:
    """Which embedding model a fusion/GCN model trains."""
    return "LightGCNOpti" if model.endswith("Opti") else "LightGCN"


def checkpoint_path(cfg: Config) -> str:
    """Where the trainer writes the embedding model's final tables."""
    return os.path.join(cfg.model_path, f"{cfg.k}_{_embedding_model_name(cfg.model)}.npz")


def get_or_train_params(
    graph: InteractionGraph,
    cfg: Config,
    device: torch.device | str,
    user_features: Optional[np.ndarray] = None,
    item_features: Optional[np.ndarray] = None,
) -> LightGCNParams:
    """The cached checkpoint's tables on ``device``; when it is missing or
    its shape does not match the graph, the embedding model is trained on
    ``device`` (with the side features for LightGCNOpti only) and its
    checkpoint written."""
    log = get_logger()
    name = _embedding_model_name(cfg.model)
    ckpt = checkpoint_path(cfg)
    params = load_checkpoint(ckpt, device)
    if params is not None:
        if (params.user_emb.shape[0], params.item_emb.shape[0]) == (graph.n_users, graph.n_items):
            log.info("loaded cached %s checkpoint: %s", name, ckpt)
            return params
        log.info("cached checkpoint shape mismatch, retraining")
    feats = (user_features, item_features) if name == "LightGCNOpti" else (None, None)
    return train_lightgcn(graph, cfg, *feats, device=device).params

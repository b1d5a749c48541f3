"""Model dispatch: the checkpoint a model serves from.

Port of ``_embedding_model_name`` and the load half of
``get_or_train_params`` in ``lgcnhs_tpu/models/recommenders.py`` (reference
``model/LightGCN/recommend.py:148-154``). Training is not ported yet, so a
missing or mismatched checkpoint raises instead of training.
"""
from __future__ import annotations

import os

import torch

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.graph import InteractionGraph
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.runtime.logging import get_logger
from lgcnhs_tpu_torch.train.trainer import load_checkpoint


def _embedding_model_name(model: str) -> str:
    """Which embedding model a fusion/GCN model trains."""
    return "LightGCNOpti" if model.endswith("Opti") else "LightGCN"


def checkpoint_path(cfg: Config) -> str:
    """Where the trainer writes the embedding model's final tables."""
    return os.path.join(cfg.model_path, f"{cfg.k}_{_embedding_model_name(cfg.model)}.npz")


def get_or_train_params(
    graph: InteractionGraph, cfg: Config, device: torch.device | str
) -> LightGCNParams:
    """The cached checkpoint's tables on ``device``."""
    ckpt = checkpoint_path(cfg)
    params = load_checkpoint(ckpt, device)
    if params is None:
        raise FileNotFoundError(
            f"no checkpoint at {ckpt}; training is not ported yet, so serving "
            "needs an npz checkpoint (keys user_emb, item_emb)"
        )
    if (params.user_emb.shape[0], params.item_emb.shape[0]) != (graph.n_users, graph.n_items):
        raise ValueError(
            f"checkpoint {ckpt} holds {params.user_emb.shape[0]} users x "
            f"{params.item_emb.shape[0]} items, the graph {graph.n_users} x "
            f"{graph.n_items}; training is not ported yet"
        )
    get_logger().info("loaded cached %s checkpoint: %s", _embedding_model_name(cfg.model), ckpt)
    return params

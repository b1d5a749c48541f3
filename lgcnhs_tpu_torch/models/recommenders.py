"""Model dispatch: load the cached checkpoint, else train; recommend for
every model family.

Port of ``lgcnhs_tpu/models/recommenders.py`` (reference per-model
``recommend.py`` entry points and ``model/LightGCN/recommend.py:148-154``),
single device. ``recommend_gcn`` has no chunked-CSR branch past 4 GB: the
JAX package needs it for the TPU's memory, and the port's retrieval kernel
serves any catalog with the same ids (ROADMAP section 3).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.graph import InteractionGraph, pos_bool_matrix
from lgcnhs_tpu_torch.models.fusion import recommend_fused
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.models.spread import SPREAD_METHODS, recommend_spread_method
from lgcnhs_tpu_torch.ops.topk import retrieve_topk
from lgcnhs_tpu_torch.runtime.logging import get_logger, stage_timer
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


def recommend_gcn(graph: InteractionGraph, cfg: Config, params: LightGCNParams) -> np.ndarray:
    """LightGCN[Opti] final recommendations, (U, k) int32: layer-0 scores,
    train AND val positives masked to -1024, top-k
    (``model/LightGCN/recommend.py:68-125``), through
    ``ops.topk.retrieve_topk`` on the tables' device (the fused retrieval
    kernel on CUDA for f32 tables)."""
    if tuple(cfg.compute.mesh_shape) != (1, 1):
        raise NotImplementedError(
            "the item-sharded retrieval (compute.mesh_shape) is not ported to "
            "lgcnhs_tpu_torch yet (ROADMAP queue 1 item 7)"
        )
    seen = torch.from_numpy(
        pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
    ).to(params.user_emb.device)
    return retrieve_topk(params.user_emb, params.item_emb, seen, cfg.k).cpu().numpy()


def recommend(
    graph: InteractionGraph,
    cfg: Config,
    device: torch.device | str,
    user_features: Optional[np.ndarray] = None,
    item_features: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Model switch on ``device`` (reference ``main.py:66-80``)."""
    model = cfg.model
    if model in SPREAD_METHODS:
        return recommend_spread_method(graph, cfg, device, model)
    params = get_or_train_params(graph, cfg, device, user_features, item_features)
    if model in ("LightGCN", "LightGCNOpti"):
        with stage_timer(f"{model} recommendation done", get_logger()):
            return recommend_gcn(graph, cfg, params)
    if model in ("SpreadLightGCN", "SpreadLightGCNOpti"):
        return recommend_fused(graph, cfg, params)
    raise ValueError(f"unknown model {model!r}")

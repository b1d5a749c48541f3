"""Model dispatch: load the cached checkpoint, else train; recommend for
every model family.

Port of ``lgcnhs_tpu/models/recommenders.py`` (reference per-model
``recommend.py`` entry points and ``model/LightGCN/recommend.py:148-154``); with a mesh
(``compute.mesh_shape``) training, retrieval and the fused ranking run
sharded (``parallel/sharding``).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.graph import (
    EdgeSet, InteractionGraph, dense_seen, edge_array, pos_bool_matrix,
)
from lgcnhs_tpu_torch.models.fusion import recommend_fused
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.models.spread import SPREAD_METHODS, recommend_spread_method
from lgcnhs_tpu_torch.ops.cuda.launches import count
from lgcnhs_tpu_torch.ops.scalable import chunked_masked_topk, user_csr
from lgcnhs_tpu_torch.ops.topk import retrieve_topk
from lgcnhs_tpu_torch.parallel.sharding import distributed_retrieve_topk
from lgcnhs_tpu_torch.runtime.logging import get_logger, span, stage_timer
from lgcnhs_tpu_torch.runtime.mesh import mesh_from_config
from lgcnhs_tpu_torch.train import trainer
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
    kernel on CUDA for f32 tables). The one LightGCN[Opti] serving path, of
    ``cli/main`` (through ``recommend``) and ``cli/retrieve`` alike.

    On one device the (2, n) int32 train+val ``edge_array`` is written on
    the host, uploaded once, and seen is set on the tables' device from it
    (``data/graph.dense_seen``); nothing is kept between calls. When the
    (U, I) f32 scores would pass the trainer's 4 GB
    ``DENSIFY_BUDGET_BYTES`` (the JAX branch's 4e9), retrieval runs in user
    chunks with seen masks from a CSR of train+val
    (``ops/scalable.chunked_masked_topk``): the same ids, no (U, I) array.
    With a mesh the catalog is item-sharded and ranked by the distributed
    top-k merge (``parallel/sharding.distributed_retrieve_topk``: the
    retrieval kernel on each rank's items on CUDA).

    Each call is a ``retrieve.pass`` span (counted in
    ``recommend_gcn.passes``) holding ``retrieve.build`` (the edge array on
    the host, then seen on the device; the chunked branch's CSR; the mesh's
    host seen), ``retrieve.upload`` (the edge array's copy;
    ``recommend_gcn.h2d_bytes`` adds its 8 n bytes, n the train+val rows),
    ``retrieve.rank`` (the launch, the chunks or the plain chain) and
    ``retrieve.download`` (``.cpu().numpy()``, which waits for the card)."""
    mesh = mesh_from_config(cfg.compute)
    ue, ie = params.user_emb, params.item_emb
    count(_COUNTERS, "passes")
    with span("retrieve.pass"):
        if mesh is None and 4.0 * graph.n_users * graph.n_items > trainer.DENSIFY_BUDGET_BYTES:
            with span("retrieve.build"):
                seen_edges = EdgeSet(np.concatenate([graph.train.users, graph.val.users]),
                                     np.concatenate([graph.train.items, graph.val.items]))
                rowptr, cols = user_csr(graph.n_users, seen_edges)
            with span("retrieve.rank"):
                rec = chunked_masked_topk(ue, ie, rowptr, cols, cfg.k)
        elif mesh is not None:
            with span("retrieve.build"):
                seen = torch.from_numpy(
                    pos_bool_matrix(graph.n_users, graph.n_items, graph.train, graph.val))
            with span("retrieve.rank"):
                rec = distributed_retrieve_topk(mesh, ue, ie, seen, cfg.k)
        else:
            with span("retrieve.build"):
                edges = edge_array(graph.train, graph.val)
            with span("retrieve.upload"):
                count(_COUNTERS, "h2d_bytes", edges.nbytes)
                edges = torch.from_numpy(edges).to(ue.device)
            with span("retrieve.build"):
                seen = dense_seen(graph.n_users, graph.n_items, edges)
                del edges
            with span("retrieve.rank"):
                rec = retrieve_topk(ue, ie, seen, cfg.k)
        with span("retrieve.download"):
            return rec.cpu().numpy()


recommend_gcn.passes = 0  # calls
recommend_gcn.h2d_bytes = 0  # bytes of the host arrays the calls handed to .to(device)
_COUNTERS = recommend_gcn  # their owner, also where a caller wraps the module's name


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

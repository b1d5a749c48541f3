"""A dry run of the mesh path on CPU ranks.

Counterpart of ``__graft_entry__.dryrun_multichip`` (which builds an
n-device JAX mesh of virtual CPU devices): ``dryrun_multichip(n)`` spawns
n CPU processes on gloo, joined through a file store in a temporary
directory (``runtime/mesh.spawn_ranks``), and on a (data, model) mesh of
them runs the flagship path through its entry points: ``train_lightgcn``
with ``compute.mesh_shape`` set (row-sharded tables and Adam state,
item-sharded incidence and positives, a data-sharded batch when n allows
two data rows, the distributed top-k evaluation), then ``recommend_gcn``
(the distributed retrieval) and the item-sharded ``recommend_fused`` (the
sharded diffusion and the distributed spread ranker), on a tiny synthetic
graph. Then the mesh x large-graph composition on the same mesh: the graph
forced onto the COO propagation (``compute.dense_threshold=1.0``) trains
with its edge list sharded and the tables replicated, and again with
``compute.coo_table_sharding`` (tables and Adam state row-sharded), whose
train losses must match the replicated plan's within 2e-5
(``__graft_entry__.py:132-161``).

    python -c "from lgcnhs_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(4)"
"""
from __future__ import annotations

import tempfile

import numpy as np


def _check_history(history, what: str) -> None:
    if not history["train_loss"]:
        raise RuntimeError(f"no {what} training happened")
    for name, series in history.items():
        if not all(np.isfinite(v) for v in series):
            raise RuntimeError(f"{what} history {name} is not finite: {series}")


def _rank(rank: int, n: int, store: str) -> None:
    import torch
    import torch.distributed as dist

    from lgcnhs_tpu_torch.config import load_config
    from lgcnhs_tpu_torch.data.datasets import load_dataset
    from lgcnhs_tpu_torch.data.graph import build_graph
    from lgcnhs_tpu_torch.models.fusion import recommend_fused
    from lgcnhs_tpu_torch.models.recommenders import recommend_gcn
    from lgcnhs_tpu_torch.runtime.mesh import init_distributed
    from lgcnhs_tpu_torch.train.trainer import train_lightgcn

    torch.set_num_threads(1)
    init_distributed(f"file://{store}", n, rank, device="cpu")
    try:
        # both axes when n allows: data-parallel batch x model-sharded tables
        data_ax = 2 if n % 2 == 0 and n >= 4 else 1
        over = {"compute.mesh_shape": (data_ax, n // data_ax), "hparams.epochs": 4,
                "hparams.epoch_per_eval": 2, "hparams.batch_size": 64, "k": 8,
                "synthetic_users": 48, "synthetic_items": 100, "synthetic_interactions": 1500}
        cfg = load_config(env="dev", dataset="synthetic", model="SpreadLightGCNOpti",
                          overrides=over)
        splits, user_features, item_features = load_dataset(cfg, "cpu")
        graph = build_graph(splits)
        result = train_lightgcn(graph, cfg, user_features, item_features, save_artifacts=False,
                                device="cpu")
        _check_history(result.history, "mesh")
        if tuple(result.params.user_emb.shape) != (graph.n_users, cfg.hparams.embedding_dim):
            raise RuntimeError(f"tables of shape {tuple(result.params.user_emb.shape)}")
        for rec in (recommend_gcn(graph, cfg, result.params),
                    recommend_fused(graph, cfg, result.params)):
            if rec.shape != (graph.n_users, cfg.k) or rec.min() < 0 or rec.max() >= graph.n_items:
                raise RuntimeError(f"a list of shape {rec.shape} with ids outside the catalog")

        # the mesh x large-graph composition: the COO propagation forced
        coo = {**over, "compute.dense_threshold": 1.0}
        results = [train_lightgcn(graph, load_config(
            env="dev", dataset="synthetic", model="SpreadLightGCN",
            overrides={**coo, "compute.coo_table_sharding": sharded}), save_artifacts=False,
            device="cpu") for sharded in (False, True)]
        for res, what in zip(results, ("edge-sharded COO", "table-sharded COO")):
            _check_history(res.history, what)
        replicated, sharded = results
        if sharded.params.user_emb.shape != replicated.params.user_emb.shape:
            raise RuntimeError(f"table-sharded tables of shape {sharded.params.user_emb.shape}")
        gap = np.abs(np.subtract(sharded.history["train_loss"],
                                 replicated.history["train_loss"])).max()
        if not gap <= 2e-5:
            raise RuntimeError(f"table-sharded train loss {gap:.3e} from the replicated plan's")
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> None:
    """Run the flagship mesh path and the mesh COO plans on ``n_devices``
    CPU ranks; raises when a rank fails or the run outlasts ``timeout``
    seconds."""
    from lgcnhs_tpu_torch.runtime.mesh import spawn_ranks

    with tempfile.TemporaryDirectory() as tmp:
        try:
            spawn_ranks(_rank, n_devices, tmp, timeout=timeout)
        except RuntimeError as e:
            raise RuntimeError(f"dryrun_multichip({n_devices}): {e}") from None

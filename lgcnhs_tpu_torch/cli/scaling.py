"""Multi-device scaling ladder: the sharded train step at a ladder of mesh
sizes, one JSON row a rung (``devices``, ``examples_per_sec``, ``speedup``,
``efficiency``).

Port of ``lgcnhs_tpu/cli/scaling.py``: the dense sharded step
(``measure_mesh``) or, with ``--coo``, the edge-sharded COO step
(``measure_mesh_coo``: ``--coo-layout bucketed|segment``,
``--coo-table-sharding`` for the row-sharded tables), over a (1, m) mesh,
on a seeded synthetic graph at the prod preset. JAX runs every rung in one
process on the first m of its devices; here ``make_mesh`` takes every rank
of the process group, so each rung is a process group of its own: ``main``
spawns m rank processes joined through a file store in a temporary
directory (``runtime/mesh.spawn_ranks``), NCCL ranks on ``cuda:0..m-1``, or
gloo ranks with ``--device cpu``. A rung of more ranks than devices (CUDA
cards, or CPU cores with ``--device cpu``) is dropped and logged. The clock
reads wait for every rank and for the card.

Usage:
  python -m lgcnhs_tpu_torch.cli.scaling --users 6040 --items 3706 \\
      --interactions 1000000 --steps 50 --meshes 1 2 4 8
  python -m lgcnhs_tpu_torch.cli.scaling --device cpu --meshes 1 2 4 --coo
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time

import numpy as np

#: seconds a rung's ranks may take, building the graph included
RUNG_TIMEOUT_S = 1800.0


def _sync(mesh) -> None:
    """Wait for every rank, and for the card on a CUDA rank."""
    import torch
    import torch.distributed as dist

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    dist.barrier()


def _examples_per_sec(mesh, hp, steps: int, chunk: int, scan, params, args) -> float:
    """Examples a second of ``scan`` over ``steps`` epochs (rounded up to
    whole chunks) in chunks of ``chunk``, after one chunk of warm-up, from
    the (3, epoch) generators."""
    chunk = max(1, chunk)
    scan(params, 3, 0, chunk, *args)
    n_chunks = -(-steps // chunk)  # at least the requested steps
    _sync(mesh)
    t0 = time.perf_counter()
    for c in range(n_chunks):
        scan(params, 3, (c + 1) * chunk, chunk, *args)
    _sync(mesh)
    return hp.batch_size * n_chunks * chunk / (time.perf_counter() - t0)


def _init(mesh, n_users: int, n_items: int, dim: int, sharded: bool):
    """LightGCN's seeded tables: this rank's padded row blocks, or whole."""
    import torch

    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, init_lightgcn
    from lgcnhs_tpu_torch.parallel.sharding import make_plan, shard_params
    from lgcnhs_tpu_torch.runtime.mesh import replicated

    init = init_lightgcn(torch.Generator().manual_seed(0), n_users, n_items, dim)
    tables = shard_params(make_plan(mesh), init) if sharded else \
        LightGCNParams(*(replicated(mesh, t) for t in init))
    return LightGCNParams(*(t.requires_grad_(True) for t in tables))


def measure_mesh(n_model: int, graph, hp, steps: int, chunk: int = 1) -> float:
    """Examples a second of the dense sharded step on a (1, n_model) mesh
    of the running process group (f32 incidence, item-sharded)."""
    from lgcnhs_tpu_torch.data.graph import normalized_bipartite, pos_bool_matrix
    from lgcnhs_tpu_torch.parallel.sharding import (
        make_plan, make_sharded_train_scan, shard_train_inputs,
    )
    from lgcnhs_tpu_torch.runtime.mesh import make_mesh
    from lgcnhs_tpu_torch.train.trainer import make_optimizer

    mesh = make_mesh((1, n_model))
    plan = make_plan(mesh)
    U, I = graph.n_users, graph.n_items
    R_blk, pos_blk, eu, ei = shard_train_inputs(
        plan, normalized_bipartite(U, I, graph.train), pos_bool_matrix(U, I, graph.train),
        graph.train.users, graph.train.items)
    params = _init(mesh, U, I, hp.embedding_dim, sharded=True)
    scan = make_sharded_train_scan(plan, make_optimizer(hp, params), hp, I)
    return _examples_per_sec(mesh, hp, steps, chunk, scan, params, (R_blk, eu, ei, pos_blk))


def measure_mesh_coo(n_model: int, graph, hp, steps: int, chunk: int = 1,
                     layout: str = "bucketed", table_sharded: bool = False) -> float:
    """Examples a second of the edge-sharded COO step on a (1, n_model)
    mesh: tables whole on every rank (``layout`` "bucketed" or "segment"),
    or with ``table_sharded`` row-sharded with Adam's state (the bucketed
    layout over the padded catalog)."""
    import torch

    from lgcnhs_tpu_torch.data.graph import EdgeSet
    from lgcnhs_tpu_torch.ops.propagation import edge_gcn_norm
    from lgcnhs_tpu_torch.ops.scalable import csr_keys, user_csr
    from lgcnhs_tpu_torch.parallel.sharding import (
        make_plan, make_sharded_coo_train_scan, make_table_sharded_coo_train_scan,
        padded_catalog, shard_bucketed_incidence, shard_coo_edges,
    )
    from lgcnhs_tpu_torch.runtime.mesh import make_mesh
    from lgcnhs_tpu_torch.train.trainer import make_optimizer

    mesh = make_mesh((1, n_model))
    plan = make_plan(mesh)
    dev = mesh.device
    U, I = graph.n_users, graph.n_items
    eu_np, ei_np = np.asarray(graph.train.users), np.asarray(graph.train.items)
    edge_users = torch.from_numpy(eu_np.astype(np.int64)).to(dev)
    edge_items = torch.from_numpy(ei_np.astype(np.int64)).to(dev)
    edge_norm = edge_gcn_norm(edge_users, edge_items, U, I)
    keys = csr_keys(*user_csr(U, EdgeSet(eu_np, ei_np)), dev)
    if layout == "bucketed" or table_sharded:
        # table-sharded: the incidence aggregates into the padded tables
        sizes = padded_catalog(plan, U, I) if table_sharded else (U, I)
        se = shard_bucketed_incidence(plan, eu_np, ei_np, edge_norm.cpu().numpy(), *sizes)
    else:
        se = shard_coo_edges(plan, eu_np, ei_np, edge_norm)
    params = _init(mesh, U, I, hp.embedding_dim, sharded=table_sharded)
    optimizer = make_optimizer(hp, params)
    if table_sharded:
        scan = make_table_sharded_coo_train_scan(plan, optimizer, hp, U, I)
    else:
        scan = make_sharded_coo_train_scan(plan, optimizer, hp, U, I, layout=layout)
    return _examples_per_sec(mesh, hp, steps, chunk, scan, params,
                             (se, edge_users, edge_items, keys))


def _rung(rank: int, m: int, store: str, device: str, args: dict, out: str) -> None:
    """One rank of an m-rank rung: joins its process group, builds the
    graph, measures; rank 0 writes the rate to ``out``."""
    import torch
    import torch.distributed as dist

    from lgcnhs_tpu_torch.config import load_config
    from lgcnhs_tpu_torch.data.graph import build_graph
    from lgcnhs_tpu_torch.data.ratings import prepare_ratings
    from lgcnhs_tpu_torch.data.synthetic import synthesize_movielens_like
    from lgcnhs_tpu_torch.runtime.mesh import backend_for

    if device == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend_for(device), init_method=f"file://{store}", world_size=m,
                            rank=rank)
    try:
        cfg = load_config(env="prod", dataset="synthetic", model="LightGCN")
        hp = dataclasses.replace(cfg.hparams, batch_size=args["batch_size"])
        df = synthesize_movielens_like(args["users"], args["items"], args["interactions"],
                                       seed=42)
        graph = build_graph(prepare_ratings(df, cfg))
        if args["coo"]:
            rate = measure_mesh_coo(m, graph, hp, args["steps"], args["chunk"],
                                    layout=args["coo_layout"],
                                    table_sharded=args["coo_table_sharding"])
        else:
            rate = measure_mesh(m, graph, hp, args["steps"], args["chunk"])
        if rank == 0:
            with open(out, "w") as f:
                json.dump(rate, f)
    finally:
        dist.destroy_process_group()


def _device_count(device_type: str) -> int:
    """Devices a rung may take: the CUDA cards, or the CPU cores."""
    if device_type == "cuda":
        import torch

        return torch.cuda.device_count()
    return os.cpu_count() or 1


def main(argv=None):
    from lgcnhs_tpu_torch.runtime.device import resolve_device
    from lgcnhs_tpu_torch.runtime.logging import get_logger
    from lgcnhs_tpu_torch.runtime.mesh import spawn_ranks

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--users", type=int, default=943)
    parser.add_argument("--items", type=int, default=1682)
    parser.add_argument("--interactions", type=int, default=100_000)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--chunk", type=int, default=1,
                        help="epochs a timed call of the scan runs (the JAX lax.scan chunk)")
    parser.add_argument("--meshes", type=int, nargs="+", default=None)
    parser.add_argument("--coo", action="store_true",
                        help="measure the edge-sharded COO (large-graph) trainer")
    parser.add_argument("--coo-layout", choices=("bucketed", "segment"), default="bucketed",
                        help="per-shard aggregation for --coo: bucketed ELL (production) "
                             "or sorted segment sums")
    parser.add_argument("--coo-table-sharding", action="store_true",
                        help="with --coo: measure the row-sharded-tables plan (~1/n_model "
                             "persistent table bytes per device) instead of replicated tables")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="NCCL ranks on the CUDA cards (default; raises without one) or "
                             "gloo ranks on the CPU")
    args = parser.parse_args(argv)
    if args.coo_table_sharding and args.coo_layout == "segment":
        parser.error("--coo-table-sharding runs the bucketed-ELL aggregation; "
                     "it cannot measure --coo-layout segment")
    device = resolve_device(args.device)
    log = get_logger()
    n_dev = _device_count(device.type)
    meshes = args.meshes or [m for m in (1, 2, 4, 8, 16) if m <= n_dev]
    for m in meshes:
        if m > n_dev:
            log.warning("scaling: dropping the %d-device rung (%d %s devices here)", m, n_dev,
                        device.type)
    rows, base_rate = [], None
    for m in (m for m in meshes if m <= n_dev):
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "rate.json")
            spawn_ranks(_rung, m, tmp, (device.type, vars(args), out), timeout=RUNG_TIMEOUT_S)
            with open(out) as f:
                rate = json.load(f)
        if base_rate is None:
            base_rate = rate
        rows.append({"devices": m, "examples_per_sec": round(rate, 1),
                     "speedup": round(rate / base_rate, 2),
                     "efficiency": round(rate / (base_rate * m), 3)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()

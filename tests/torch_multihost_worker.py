"""One rank of the port's two-process ``tcp://`` smoke (driven by
``tests/test_torch_multihost.py``), the counterpart of
``tests/multihost_worker.py``.

Each process joins the process group through a ``host:port`` address
(``runtime/mesh.init_distributed``: the ``tcp://`` init method, gloo on the
CPU), builds a (1, 2) mesh over both processes (the port runs one process a
device) and runs ONE ``make_sharded_train_step`` on the JAX worker's toy
graph, then joins the sharded tables. Rank 0 writes the joined tables to
OUT.

Usage: python torch_multihost_worker.py <rank> <world_size> <port> <out.npz>
Prints "RESULT <rank> <world_size> <loss>" (the loss as ``repr`` of the
float) on success.
"""
import sys

import numpy as np
import torch

U, I, D = 32, 64, 8
SEED, INIT_SEED, BATCH = 5, 0, 32


def toy_graph():
    """``tests/multihost_worker.py``'s graph: 400 seeded draws, deduplicated."""
    from lgcnhs_tpu_torch.data.graph import EdgeSet

    rng = np.random.default_rng(SEED)
    pairs = np.unique(np.stack([rng.integers(0, U, 400), rng.integers(0, I, 400)]), axis=1)
    return EdgeSet(pairs[0].astype(np.int32), pairs[1].astype(np.int32))


def hparams():
    from lgcnhs_tpu_torch.config import load_config

    hp = load_config(env="dev", dataset="synthetic", model="LightGCN").hparams
    return hp.__class__(**{**hp.__dict__, "batch_size": BATCH, "embedding_dim": D})


def main() -> None:
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)

    import torch.distributed as dist

    from lgcnhs_tpu_torch.data.graph import normalized_bipartite, pos_bool_matrix
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, init_lightgcn
    from lgcnhs_tpu_torch.parallel import sharding
    from lgcnhs_tpu_torch.runtime.mesh import init_distributed, make_mesh
    from lgcnhs_tpu_torch.train.trainer import epoch_generator, make_optimizer

    n = init_distributed(f"127.0.0.1:{port}", world, rank, "cpu")
    try:
        if n != world or dist.get_rank() != rank or dist.get_backend() != "gloo":
            raise RuntimeError(f"group of {n} ranks, rank {dist.get_rank()}, "
                               f"backend {dist.get_backend()}")
        es = toy_graph()
        mesh = make_mesh((1, world))  # spans both processes
        plan = sharding.make_plan(mesh)
        R_blk, pos_blk, eu, ei = sharding.shard_train_inputs(
            plan, normalized_bipartite(U, I, es), pos_bool_matrix(U, I, es), es.users, es.items)
        init = init_lightgcn(torch.Generator().manual_seed(INIT_SEED), U, I, D)
        params = LightGCNParams(*(t.clone().requires_grad_(True)
                                  for t in sharding.shard_params(plan, init)))
        hp = hparams()
        step = sharding.make_sharded_train_step(plan, make_optimizer(hp, params), hp, I)
        loss = float(step(params, 0, epoch_generator(1, 0, mesh.device), R_blk, eu, ei, pos_blk))
        if not np.isfinite(loss):
            raise RuntimeError(f"loss {loss}")
        joined = sharding.unpad_params(params, U, I, mesh)
        if rank == 0:
            np.savez(out, user_emb=joined.user_emb.numpy(), item_emb=joined.item_emb.numpy())
        print(f"RESULT {rank} {n} {loss!r}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

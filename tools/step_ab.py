#!/usr/bin/env python3
"""A/B timing of the LightGCN train step of two or more checkouts on one card.

    python3 tools/step_ab.py ROOT [ROOT ...]

Each ROOT is a checkout that holds ``lgcnhs_tpu_torch`` (``.`` for this
one; an earlier commit unpacked with ``git archive`` into a git-ignored
directory for another). Each ROOT runs in a process of its own, importing
its own package: the prod preset's train step at ML-1M scale (LightGCNOpti,
D=64, batch 1024, bf16, the int8 incidence through ``dual_matmul``), 20
steps to warm up, then five synchronized windows of 100 steps; the process
reports its fastest window's ms per step (the step is host-bound, and the
host's other load only ever slows a window). The ROOTs run in order, then
reversed, five times over (A B B A ...: ten pairs), so that each is timed
next to the others on the same card and host. Prints one line per ROOT
with its times and the card's name and power limit.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

WARMUP, STEPS, WINDOWS, ROUNDS = 20, 100, 5, 5


def one(root: str) -> None:
    """Times the train step of the package under ``root``; prints the
    fastest window's ms/step."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import lgcnhs_tpu_torch
    from lgcnhs_tpu_torch import config as tcfg
    from lgcnhs_tpu_torch.data.datasets import load_dataset
    from lgcnhs_tpu_torch.data.graph import build_graph, pos_bool_matrix, unique_edges
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, init_lightgcn_opti
    from lgcnhs_tpu_torch.ops.cuda import propagation as prop
    from lgcnhs_tpu_torch.train import trainer

    where = os.path.dirname(os.path.dirname(os.path.abspath(lgcnhs_tpu_torch.__file__)))
    if os.path.realpath(where) != os.path.realpath(root):
        raise RuntimeError(f"imported lgcnhs_tpu_torch from {where}, not {root}")
    dev = torch.device("cuda", 0)
    cfg = tcfg.load_config(env="prod", dataset="movielens1m", model="LightGCNOpti",
                           workdir=os.path.join(root, "artifacts", "step_ab"))
    splits, feats_u, feats_i = load_dataset(cfg)
    graph = build_graph(splits)
    U, I, hp = graph.n_users, graph.n_items, cfg.hparams
    R8, du, di = trainer.device_binary_factors(U, I, graph.train, dev)
    # what each version's trainer hands the step: R padded once, or (the
    # earlier kernel) R and its transposed copy
    if hasattr(prop, "pad_for_dual"):
        R_hat = (prop.pad_for_dual(R8), du, di)
    else:
        R_hat = (R8, du, di, prop.transpose_for_dual(R8))
    p = init_lightgcn_opti(torch.Generator().manual_seed(0), feats_u, feats_i,
                           hp.embedding_dim, dev)
    p = LightGCNParams(*(t.clone().requires_grad_(True) for t in p))
    step = trainer.make_train_step(trainer.make_optimizer(hp, p), hp, I, bf16_matmul=True,
                                   use_kernel=True)
    te = unique_edges(graph.train)
    args = (R_hat, torch.from_numpy(te.users.astype(np.int64)).to(dev),
            torch.from_numpy(te.items.astype(np.int64)).to(dev),
            torch.from_numpy(pos_bool_matrix(U, I, graph.train)).to(dev))
    launches = prop.dual_matmul.launches
    for e in range(WARMUP):
        step(p, e, trainer.epoch_generator(hp.seed, e, dev), *args)
    torch.cuda.synchronize()
    if prop.dual_matmul.launches - launches != 6 * WARMUP:
        raise RuntimeError("the step did not launch dual_matmul 6 times")
    best = float("inf")
    for w in range(WINDOWS):
        t0 = time.perf_counter()
        for e in range(WARMUP + w * STEPS, WARMUP + (w + 1) * STEPS):
            step(p, e, trainer.epoch_generator(hp.seed, e, dev), *args)
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) * 1e3 / STEPS)
    print(f"{best:.4f}", flush=True)


def main(roots) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    times = {r: [] for r in roots}
    for _ in range(ROUNDS):
        for r in roots + roots[::-1]:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", r],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                print(out.stdout + out.stderr, file=sys.stderr)
                return 1
            times[r].append(float(out.stdout.strip().splitlines()[-1]))
    for r in roots:
        print(f"train step {r} ms: {' '.join(f'{t:.4f}' for t in times[r])} "
              f"(median {sorted(times[r])[len(times[r]) // 2]:.4f}) [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        one(os.path.abspath(sys.argv[2]))
        sys.exit(0)
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots or any(r.startswith("-") for r in sys.argv[1:]):
        print(__doc__)
        sys.exit(2)
    sys.exit(main(roots))

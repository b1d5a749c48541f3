#!/usr/bin/env python3
"""Where a CSR evaluation's I@k time goes at the large-graph scale, on one
card: the pair gather on the host, as the JAX package reads its pairs
(``lgcnhs_tpu/ops/scalable.py:235-296``), against the port's
``ops/scalable.internal_similarity_csr``, which reads them on the card.

    python3 tools/iak_ab.py [--users 50000] [--items 30000] [--interactions 2900000]

The lists are the masked top-100 of the seeded LightGCNOpti tables at
epoch 0 on the prod preset's synthetic draw (those of ``chip_smoke.py``
phase 6), ranked by ``chunked_masked_topk`` on the card. Both forms read
the same Gram over the distinct recommended items (scipy, host); the host
form gathers each list's pairs i < j with scipy's element gather (a binary
search of each sorted Gram row), chunks of 2^22 pairs on up to 8 threads,
summed in f64. Prints the seconds of the Gram build, of each gather, the
two values and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def host_pairs(rec, edges, n_users, n_items, item_deg, chunk_pairs=1 << 22):
    """(I@k, Gram seconds, gather seconds): the Gram over the recommended
    items, then each list's pairs gathered and weighted on the host."""
    import numpy as np
    import scipy.sparse as sp

    t0 = time.perf_counter()
    U, k = rec.shape
    uniq, inv = np.unique(rec.ravel(), return_inverse=True)
    A = sp.csr_matrix((np.ones(len(edges[0]), np.float32), edges), shape=(n_users, n_items))
    A.data[:] = 1.0
    Asub = A[:, uniq]
    G = (Asub.T @ Asub).tocsr()
    G.sort_indices()
    gram_s = time.perf_counter() - t0
    deg = np.asarray(item_deg, np.float64)[uniq]
    with np.errstate(divide="ignore"):
        inv_sqrt = np.where(deg > 0, 1.0 / np.sqrt(deg), 0.0)
    ridx = inv.reshape(U, k)
    iu, ju = np.triu_indices(k, 1)
    per = max(1, chunk_pairs // iu.shape[0])

    def chunk(s):
        r = ridx[s:s + per]
        rows, cols = r[:, iu].ravel(), r[:, ju].ravel()
        vals = np.asarray(G[rows, cols], dtype=np.float64).ravel()
        return float((vals * inv_sqrt[rows] * inv_sqrt[cols])[rows != cols].sum())

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        total = sum(pool.map(chunk, range(0, U, per)))
    return 2.0 * total / (U * k * (k - 1)), gram_s, time.perf_counter() - t0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--users", type=int, default=50_000)
    p.add_argument("--items", type=int, default=30_000)
    p.add_argument("--interactions", type=int, default=2_900_000)
    args = p.parse_args()
    import numpy as np
    import torch

    from lgcnhs_tpu_torch import config as tcfg
    from lgcnhs_tpu_torch.data.datasets import load_dataset
    from lgcnhs_tpu_torch.data.graph import build_graph, item_degrees
    from lgcnhs_tpu_torch.models.lightgcn import init_lightgcn_opti
    from lgcnhs_tpu_torch.ops import scalable

    if not torch.cuda.is_available():
        print("iak_ab: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    cfg = tcfg.load_config(env="prod", dataset="synthetic", model="LightGCNOpti", overrides={
        "synthetic_users": args.users, "synthetic_items": args.items,
        "synthetic_interactions": args.interactions})
    splits, uf, itf = load_dataset(cfg)
    g = build_graph(splits)
    U, I = g.n_users, g.n_items
    params = init_lightgcn_opti(torch.Generator().manual_seed(cfg.hparams.seed), uf, itf,
                                cfg.hparams.embedding_dim, dev)
    rowptr, cols = scalable.user_csr(U, g.train)
    rec = scalable.chunked_masked_topk(params.user_emb, params.item_emb, rowptr, cols, cfg.k)
    edges = (np.asarray(g.train.users), np.asarray(g.train.items))
    deg = item_degrees(I, g.train)
    rec_np = rec.cpu().numpy()
    print(f"[iak_ab] {U} x {I}, {g.train.n_edges} train edges, k={cfg.k}, "
          f"{np.unique(rec_np).shape[0]} distinct recommended items [{smi}]", flush=True)
    host, gram_s, gather_s = host_pairs(rec_np, edges, U, I, deg)
    print(f"[iak_ab] host pairs: I@k {host!r}; Gram {gram_s:.4f} s, gather {gather_s:.4f} s "
          f"[{smi}]", flush=True)
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card = scalable.internal_similarity_csr(rec, edges, U, I, deg)
        torch.cuda.synchronize()
        print(f"[iak_ab] internal_similarity_csr (Gram on the host, pairs on the card): I@k "
              f"{card!r} in {time.perf_counter() - t0:.4f} s; relative gap to the host form "
              f"{abs(card - host) / abs(host):.3e} [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Serving traffic: full recommendation refreshes back to back, one at a time.

Each pass is ``models/fusion.serve_fused`` over every user of the
configuration's graph at its k, train and val interactions masked: the
host's build of A and seen, their upload, the HybridS W and the fused
serving kernel. The tables are made on the card from the seed, in the
served dtype (float32), N(0, 0.1^2); nothing is trained. One pass in
set-up warms every shape the window uses. The window holds every pass
that ends at or before the first end at or after ``seconds``.
``serve_users_per_s`` is the users of those passes over the window's
time; ``serve_pass_p95_ms`` the 95th percentile of their wall times.

The check takes, from the seed, ``traffic["sample_users"]`` users and the
user with the most seen items, keeps their lists from every pass, and
judges each against the reference once the window has closed.
"""
from __future__ import annotations

import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench import judge, problem
from portbench.reference import serve as ref_serve


@dataclass
class Outcome:
    e2e: dict
    attempted: int
    failed: int
    records: dict
    sample: np.ndarray  # the judged users
    lists: list  # per pass, the sample's (S, k) lists
    tables: tuple  # (user, item) tables, the benchmark's inputs
    config: dict
    rows: dict
    seed: int


def tables(config: dict, seed: int, n_users: int, n_items: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    D = config["embedding_dim"]
    return (0.1 * torch.randn(n_users, D, generator=gen, device=device),
            0.1 * torch.randn(n_items, D, generator=gen, device=device))


def sample_users(graph, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([seed, 7])
    picked = rng.choice(graph.n_users, size=min(n, graph.n_users), replace=False)
    seen = np.bincount(np.concatenate([graph.train.users, graph.val.users]),
                       minlength=graph.n_users)
    return np.unique(np.append(picked, int(np.argmax(seen))))


def run(config: dict, traffic: dict, seed: int, window, device) -> Outcome:
    from lgcnhs_tpu_torch.models.fusion import serve_fused
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = problem.table(config, seed)
    cfg, graph = problem.program_graph(config, rows, seed,
                                       tempfile.gettempdir() + "/portbench-work")
    ue, ie = tables(config, seed, graph.n_users, graph.n_items, device)
    params = LightGCNParams(ue, ie)
    sample = sample_users(graph, traffic["sample_users"], seed)
    serve_fused(graph, cfg, params)  # warm-up: builds and loads every kernel
    window.open()
    passes, lists = [], []
    while True:
        ns0, t0 = time.time_ns(), time.perf_counter()
        rec = serve_fused(graph, cfg, params)
        t1, ns1 = time.perf_counter(), time.time_ns()
        passes.append((ns0, ns1, t1 - t0))
        lists.append(np.array(rec[sample]))
        if window.expired():
            break
    window.close()
    users = len(passes) * graph.n_users
    times = np.array([p[2] for p in passes])
    return Outcome(
        e2e={"serve_users_per_s": users / window.elapsed,
             "serve_pass_p95_ms": float(np.percentile(times, 95)) * 1e3},
        attempted=len(passes), failed=0,
        records={"passes": passes, "users_per_pass": graph.n_users},
        sample=sample, lists=lists, tables=(ue, ie), config=config, rows=rows, seed=seed)


def shapes(config: dict, split) -> dict:
    from portbench.reference.data import first_unique

    su, _ = first_unique(np.concatenate([split.train_users, split.val_users]),
                         np.concatenate([split.train_items, split.val_items]), split.n_items)
    return {"U": split.n_users, "I": split.n_items, "nnz": int(su.shape[0]),
            "D": config["embedding_dim"], "L": config["layers"], "k": config["k"],
            "batch": config["batch_size"]}


def reference_scores(outcome: Outcome, split, precision: str = "float64"):
    return ref_serve.fused_scores(split, *outcome.tables, outcome.config["lambda"],
                                  outcome.sample, precision)


def check(outcome: Outcome, device):
    """(numbers, shapes): every pass's lists of the sample against the
    reference's scores."""
    split = problem.reference_split(outcome.config, outcome.rows)
    if (split.n_users, split.n_items) != (outcome.tables[0].shape[0], outcome.tables[1].shape[0]):
        return {"score_gap": float("inf")}, shapes(outcome.config, split)
    scores = reference_scores(outcome, split)
    gap = max(judge.score_gap(lists, scores) for lists in outcome.lists)
    return {"score_gap": gap}, shapes(outcome.config, split)

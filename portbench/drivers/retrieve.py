"""Retrieval traffic: LightGCN[Opti] candidate lists for every user, one
full pass at a time, back to back.

Each pass is ``models/recommenders.recommend_gcn`` over every user of the
configuration's graph at its k, train and val interactions masked: the
edge array written on the host and uploaded, seen set on the card, the
fused retrieval kernel and the lists' download. The tables, the judged
sample, the warm-up pass in set-up and the window are the serving
driver's (``drivers/serve.py``): float32 N(0, 0.1^2) tables made on the
card from the seed, nothing trained; ``serve_users_per_s`` is the users of
the window's passes over its time, ``serve_pass_p95_ms`` the 95th
percentile of their wall times.

The check judges the sample's lists of every pass against
``reference/retrieve.py``'s float64 layer-0 scores once the window has
closed (``judge.score_gap``); passes whose lists are equal, byte for byte,
are judged once (a pass's k=1000 top-k of the reference takes ~30 ms, and
a window holds thousands).
"""
from __future__ import annotations

import tempfile
import time

import numpy as np
import torch

from portbench import judge, problem
from portbench.drivers.serve import Outcome, sample_users, shapes, tables
from portbench.reference import retrieve as ref_retrieve


def run(config: dict, traffic: dict, seed: int, window, device) -> Outcome:
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
    from lgcnhs_tpu_torch.models.recommenders import recommend_gcn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = problem.table(config, seed)
    cfg, graph = problem.program_graph(config, rows, seed,
                                       tempfile.gettempdir() + "/portbench-work")
    ue, ie = tables(config, seed, graph.n_users, graph.n_items, device)
    params = LightGCNParams(ue, ie)
    sample = sample_users(graph, traffic["sample_users"], seed)
    recommend_gcn(graph, cfg, params)  # warm-up: builds and loads the kernel
    window.open()
    passes, lists = [], []
    while True:
        ns0, t0 = time.time_ns(), time.perf_counter()
        rec = recommend_gcn(graph, cfg, params)
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


def reference_scores(outcome: Outcome, split, precision: str = "float64"):
    return ref_retrieve.layer0_scores(split, *outcome.tables, outcome.sample, precision)


def check(outcome: Outcome, device):
    """(numbers, shapes): every pass's lists of the sample against the
    reference's scores."""
    split = problem.reference_split(outcome.config, outcome.rows)
    if (split.n_users, split.n_items) != (outcome.tables[0].shape[0], outcome.tables[1].shape[0]):
        return {"score_gap": float("inf")}, shapes(outcome.config, split)
    scores = reference_scores(outcome, split)
    distinct = {lists.tobytes(): lists for lists in outcome.lists}  # equal passes judged once
    gap = max(judge.score_gap(lists, scores) for lists in distinct.values())
    return {"score_gap": gap}, shapes(outcome.config, split)

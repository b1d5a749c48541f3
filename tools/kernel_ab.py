#!/usr/bin/env python3
"""A/B timing of CUDA kernel source variants on one card.

    python3 tools/kernel_ab.py DIR [DIR ...]

Each DIR holds a variant of ``lgcnhs_tpu_torch/ops/cuda``'s ``retrieval.cu``,
``fusion_serve.cu`` and ``common.cuh`` with the package's launcher
signatures (pass that directory itself for the current sources). Every
variant is built with the package's nvcc flags, checked against the plain
twins, and timed at the serving slice's shapes (k=100): one-shot retrieval
and fused serving at ML-1M scale (6040 x 3706, D=64), streaming retrieval
over a 50k-item synthetic catalog. Rounds run the variants in A..Z, Z..A
order, three times, so every variant is timed next to every other on the
same card; each printed time is the median of 10 CUDA-event timings.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lgcnhs_tpu_torch import config as tcfg  # noqa: E402
from lgcnhs_tpu_torch.data.datasets import load_dataset  # noqa: E402
from lgcnhs_tpu_torch.data.graph import build_graph, interaction_matrix, pos_bool_matrix  # noqa: E402
from lgcnhs_tpu_torch.models.lightgcn import init_lightgcn_opti  # noqa: E402
from lgcnhs_tpu_torch.ops.cuda import build, fusion_serve as fs, retrieval as rt  # noqa: E402
from lgcnhs_tpu_torch.ops.diffusion import general_spreading_matrix, hybrid_transfer  # noqa: E402

K = 100
P, INT = ctypes.c_void_p, ctypes.c_int


def compile_variant(n, d):
    out_dir = os.path.join(ROOT, "artifacts", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name in ("retrieval", "fusion_serve"):
        out = os.path.join(out_dir, f"v{n}-lib{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
               os.path.join(d, f"{name}.cu")]
        procs.append((name, out, subprocess.Popen(cmd)))
    libs = {}
    for name, out, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"{d}/{name}.cu does not build")
        libs[name] = ctypes.CDLL(out)
    return libs


def slice_inputs(dev, dataset, over):
    cfg = tcfg.load_config(env="prod", dataset=dataset, model="LightGCNOpti",
                           workdir=os.path.join(ROOT, "artifacts", "kernel_ab"), overrides=over)
    splits, uf, itf = load_dataset(cfg)
    g = build_graph(splits)
    p = init_lightgcn_opti(torch.Generator().manual_seed(0), uf, itf, 64)
    seen = torch.from_numpy(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val)).to(dev)
    return g, p.user_emb.to(dev), p.item_emb.to(dev), seen


def main(variants):
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = {d: compile_variant(n, d) for n, d in enumerate(variants)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    g, ue, ie, seen = slice_inputs(dev, "movielens1m", {})
    A = torch.from_numpy(interaction_matrix(g.n_users, g.n_items, g.train, g.val)).to(dev)
    W = hybrid_transfer(A, general_spreading_matrix(A), 0.6)
    rows, cols = A.nonzero(as_tuple=True)
    a_val, a_col = A[rows, cols].contiguous(), cols.to(torch.int32)
    a_ptr = torch.zeros(g.n_users + 1, dtype=torch.int32, device=dev)
    a_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=g.n_users), 0)
    _, ueb, ieb, seenb = slice_inputs(
        dev, "synthetic",
        {"synthetic_users": 6040, "synthetic_items": 50_000, "synthetic_interactions": 1_000_209})
    tile = rt.pick_stream_tile(64, K, build.device_smem_limit("retrieval", dev))
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, kind):
        u, it, s = (ueb, ieb, seenb) if kind == "streaming" else (ue, ie, seen)
        itT, s8 = it.T.contiguous(), s.view(torch.uint8)
        U, I = s.shape
        D = u.shape[1]
        idx = torch.empty((U, K), dtype=torch.int32, device=dev)
        vals = torch.empty((U, K), dtype=torch.float32, device=dev)
        if kind == "fused":
            fn = lib["retrieval"].fused_topk_retrieval_launch
            fn.argtypes = [P, P, P, INT, INT, INT, INT, P, P, P]
            rc = fn(u.data_ptr(), itT.data_ptr(), s8.data_ptr(), U, I, D, K,
                    idx.data_ptr(), vals.data_ptr(), stream)
        elif kind == "streaming":
            fn = lib["retrieval"].streaming_topk_retrieval_launch
            fn.argtypes = [P, P, P, INT, INT, INT, INT, INT, P, P, P]
            rc = fn(u.data_ptr(), itT.data_ptr(), s8.data_ptr(), U, I, D, K, tile,
                    idx.data_ptr(), vals.data_ptr(), stream)
        else:
            fn = lib["fusion_serve"].fused_lgcnhs_serve_launch
            fn.argtypes = [P] * 7 + [INT] * 4 + [P] * 3
            rc = fn(u.data_ptr(), itT.data_ptr(), a_ptr.data_ptr(), a_col.data_ptr(),
                    a_val.data_ptr(), W.data_ptr(), s8.data_ptr(), U, I, D, K,
                    idx.data_ptr(), vals.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{kind}: CUDA error {rc}")
        return idx, vals

    twins = {"fused": rt.fused_topk_retrieval_ref(ue, ie, seen, K),
             "streaming": rt.fused_topk_retrieval_ref(ueb, ieb, seenb, K),
             "serve": fs.fused_lgcnhs_serve_ref(ue, ie, A, W, seen, K)}

    def median_ms(lib, kind, reps=10):
        launch(lib, kind)
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            launch(lib, kind)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[reps // 2]

    for kind in ("fused", "streaming", "serve"):
        for d in variants:
            idx, vals = launch(libs[d], kind)
            torch.cuda.synchronize()
            wi, wv = twins[kind]
            print(f"{kind} {d}: index agreement with twin "
                  f"{float((idx == wi).float().mean()):.6f}, max |value diff| "
                  f"{float((vals - wv).abs().max()):.3e}", flush=True)
        times = {d: [] for d in variants}
        for _ in range(3):
            for d in variants + variants[::-1]:
                times[d].append(median_ms(libs[d], kind))
        for d in variants:
            print(f"{kind} {d} ms: {' '.join(f'{t:.4f}' for t in times[d])} [{smi}]", flush=True)


if __name__ == "__main__":
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__)
        sys.exit(2)
    main(sys.argv[1:])

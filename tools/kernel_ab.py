#!/usr/bin/env python3
"""A/B timing of CUDA kernel source variants on one card.

    python3 tools/kernel_ab.py [--kinds fused,streaming,serve,dual] [--k K] [--items N] DIR [DIR ...]

Each DIR holds a variant of some of ``lgcnhs_tpu_torch/ops/cuda``'s
``retrieval.cu``, ``fusion_serve.cu`` and ``propagation.cu`` (with the
``common.cuh`` they include) and the package's launcher signatures; pass
``lgcnhs_tpu_torch/ops/cuda`` itself for the current sources. A
``propagation.cu`` may also have the launcher of the earlier two-layout
kernel, which read R and a transposed copy of it (``dual_matmul_launch``
without ``dual_matmul_smem_bytes``); it is then given that copy. A
``retrieval.cu`` of the package before its two retrieval kernels became one
has a streaming kernel too (``streaming_topk_retrieval_launch`` with
``streaming_workspace_bytes``), which the ``streaming`` kind times over the
50k-item catalog with that package's plan (32-user groups, ``spread_parts``,
a survivor slack of k / 8 from 16 to 256, or ``DIR:tile=N``).
A ``fusion_serve.cu`` with the earlier launcher (A as CSR, f32 W; no
``fused_serve_smem_bytes``) gets A in CSR, built once; one with the
tensor-core launcher gets A and W as bf16 parts, split once
(``ops/cuda/fusion_serve.serve_operands``), and is also held bitwise
against the twin with a W of 20 significant bits (``chip_smoke.py``'s check
that the kernel uses every bf16 part of W). A kind is timed for the variants
that have its source; fused serving's bound, the plain twin and the
matmul+topk composition are timed once beside the variants.

Every variant is built with the package's nvcc flags (``DIR:parts=N``
splits the retrieval kernel's catalog into N parts instead of its plan's),
checked against the plain twins, and timed at the main path's shapes
(k=100, or ``--k``): retrieval, fused serving and ``dual_matmul`` (int8 R,
bf16 X and Y, D=64) at ML-1M scale (6040 x 3706), an older streaming
kernel over a 50k-item synthetic catalog. ``--items N`` runs retrieval and
fused serving over a synthetic catalog instead, drawn as
``cli/retrieve --dataset synthetic --items N`` draws it (6040 users,
1,000,209 interactions; N = 50,000 keeps the 49,410 items that
``chip_smoke.py`` serves); the earlier serving launcher is
skipped where its rows do not fit a block. Rounds run the variants in A..Z, Z..A order, three times, so every
variant is timed next to every other on the same card; each printed time
is the median of 10 CUDA-event timings of one launch, then the device time
of one launch from ``torch.profiler`` over 20 launches.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lgcnhs_tpu_torch import config as tcfg  # noqa: E402
from lgcnhs_tpu_torch.data.datasets import load_dataset  # noqa: E402
from lgcnhs_tpu_torch.data.graph import build_graph, interaction_matrix, pos_bool_matrix  # noqa: E402
from lgcnhs_tpu_torch.models.lightgcn import init_lightgcn_opti  # noqa: E402
from lgcnhs_tpu_torch.ops.cuda import build, fusion_serve as fs, propagation as prop  # noqa: E402
from lgcnhs_tpu_torch.ops.cuda import retrieval as rt  # noqa: E402
from lgcnhs_tpu_torch.ops.diffusion import general_spreading_matrix, hybrid_transfer  # noqa: E402
from lgcnhs_tpu_torch.train.trainer import device_binary_factors  # noqa: E402

K = 100  # --k
ITEMS = 0  # --items: serve over a synthetic catalog of this many items
P, INT = ctypes.c_void_p, ctypes.c_int
SOURCES = {"fused": "retrieval", "streaming": "retrieval", "serve": "fusion_serve",
           "dual": "propagation"}
# NVIDIA H100 SXM peaks (NVIDIA's data sheet), as chip_smoke.py's bound
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12


def wide_w_problem(dev, U=384, I=896, D=64):
    """(user_emb, item_emb, A, W, seen): W of 20 significant bits, 12 items
    a user in A, dyadic tables, so that G*F is exact in f32 in any
    summation order and a kernel that drops a bf16 part of W differs from
    the twin."""
    g = torch.Generator(device=dev).manual_seed(1)
    W = torch.randint(1 << 19, 1 << 20, (I, I), generator=g, device=dev).float() / (1 << 20)
    A = torch.zeros((U, I), device=dev).scatter_(
        1, torch.rand((U, I), generator=g, device=dev).argsort(dim=1)[:, :12], 1.0)
    ue = torch.randint(-4, 5, (U, D), generator=g, device=dev).float() / 8
    ie = torch.randint(-4, 5, (I, D), generator=g, device=dev).float() / 8
    return ue, ie, A, W, A > 0


def events_ms(fn, reps=3):
    """Median of ``reps`` CUDA-event timings of fn, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def all_device_ms(fn, n=3):
    """Device ms of one call of fn, every kernel counted (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum((getattr(ev, "self_device_time_total", 0.0) or 0.0) for ev in prof.key_averages()
               if getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA) / 1e3 / n


def compile_variant(n, spec):
    """{source name: loaded library} of the variant ``DIR[:tile=N]``."""
    d = spec.split(":")[0]
    out_dir = os.path.join(ROOT, "artifacts", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for name in sorted(set(SOURCES.values())):
        src = os.path.join(d, f"{name}.cu")
        if not os.path.exists(src):
            continue
        out = os.path.join(out_dir, f"v{n}-lib{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out, src]
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


def main(variants, kinds):
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    libs = {v: compile_variant(n, v) for n, v in enumerate(variants)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)

    g, ue, ie, seen = slice_inputs(dev, "movielens1m", {})
    if ITEMS:  # serving over a synthetic catalog of ITEMS items
        gs, ues, ies, seens = slice_inputs(
            dev, "synthetic", {"synthetic_users": 6040, "synthetic_items": ITEMS,
                               "synthetic_interactions": 1_000_209})
    else:
        gs, ues, ies, seens = g, ue, ie, seen
    A = W = serve_ops = a_val = a_col = a_ptr = None
    if "serve" in kinds:  # W alone is 9.8 GB at 49,410 items
        A = torch.from_numpy(interaction_matrix(gs.n_users, gs.n_items, gs.train, gs.val)).to(dev)
        W = hybrid_transfer(A, general_spreading_matrix(A), 0.6)
        serve_ops = fs.serve_operands(ues, ies, A, W)
        rows, cols = A.nonzero(as_tuple=True)
        a_val, a_col = A[rows, cols].contiguous(), cols.to(torch.int32)
        a_ptr = torch.zeros(gs.n_users + 1, dtype=torch.int32, device=dev)
        a_ptr[1:] = torch.cumsum(torch.bincount(rows, minlength=gs.n_users), 0)
    serve_old = (ues, ies.T.contiguous(), seens.view(torch.uint8))
    R8 = device_binary_factors(g.n_users, g.n_items, g.train, dev)[0]
    R8p, R8T = prop.pad_for_dual(R8), R8.t().contiguous()
    X, Y = ie.to(torch.bfloat16), ue.to(torch.bfloat16)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ws = torch.empty((8 * g.n_users + 8 * g.n_items) * 64, dtype=torch.float32, device=dev)

    def splits(plib):
        """The wrapper's split rule for this variant's tile and residency."""
        slots = n_sms * plib.dual_matmul_resident_blocks(2, 1, 64)
        su, si = prop.dual_splits(g.n_users, g.n_items, plib.dual_matmul_block_rows(2, 1, 64),
                                  slots)
        if su > 8 or si > 8:
            raise RuntimeError(f"splits {su, si} exceed the workspace")
        return su, si
    ueb = ieb = seenb = None
    if "streaming" in kinds:
        _, ueb, ieb, seenb = slice_inputs(
            dev, "synthetic",
            {"synthetic_users": 6040, "synthetic_items": 50_000,
             "synthetic_interactions": 1_000_209})
    serving = {False: (ues, ies.T.contiguous(), seens.view(torch.uint8))}
    if ueb is not None:
        serving[True] = (ueb, ieb.T.contiguous(), seenb.view(torch.uint8))
    def stream_tile(lib):
        spec = lib_key(lib)
        tiles = [int(o[5:]) for o in spec.split(":")[1:] if o.startswith("tile=")]
        return tiles[-1] if tiles else max(16, min(256, K // 8))

    limit = build.device_smem_limit("retrieval", dev)
    stream_ws = {}

    def stream_workspace(lib):
        """The pointer to the long lists' workspace (those that do not fit
        shared memory), or None."""
        key = lib_key(lib)
        if key not in stream_ws:
            rlib = lib["retrieval"]
            rlib.streaming_workspace_bytes.argtypes = [INT, INT, INT]
            rlib.streaming_workspace_bytes.restype = ctypes.c_longlong
            per_block = rlib.streaming_workspace_bytes(K, stream_tile(lib), limit)
            blocks = -(-ueb.shape[0] // 32) * parts
            stream_ws[key] = torch.empty(blocks * per_block // 4, dtype=torch.int32,
                                         device=dev) if per_block else None
        return None if stream_ws[key] is None else stream_ws[key].data_ptr()
    if ueb is not None:
        uTp, itTp = rt._padded_t(ueb), rt._padded_t(ieb)
        parts, part_len = rt.spread_parts(-(-ueb.shape[0] // 32), -(-ieb.shape[0] // 128),
                                          128, n_sms)
        part_idx = torch.empty(parts * ueb.shape[0] * K, dtype=torch.int32, device=dev)
        part_val = torch.empty(parts * ueb.shape[0] * K, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(lib, kind):
        if kind == "dual":
            U, I = R8.shape
            out_u = torch.empty((U, 64), dtype=torch.float32, device=dev)
            out_i = torch.empty((I, 64), dtype=torch.float32, device=dev)
            fn = lib["propagation"].dual_matmul_launch
            if hasattr(lib["propagation"], "dual_matmul_smem_bytes"):
                fn.argtypes = [INT, INT, P, INT, P, P] + [INT] * 6 + [P] * 4
                su, si = splits(lib["propagation"])
                rc = fn(2, 1, R8p.data_ptr(), R8p.stride(0), X.data_ptr(), Y.data_ptr(), 64,
                        U, I, 64, su, si, ws.data_ptr(), out_u.data_ptr(), out_i.data_ptr(),
                        stream)
            else:  # the two-layout launcher: R and its transposed copy
                fn.argtypes = [INT, INT] + [P] * 4 + [INT] * 3 + [P] * 3
                rc = fn(2, 1, R8.data_ptr(), R8T.data_ptr(), X.data_ptr(), Y.data_ptr(),
                        U, I, 64, out_u.data_ptr(), out_i.data_ptr(), stream)
            if rc != 0:
                raise RuntimeError(f"dual: CUDA error {rc}")
            return out_u, out_i
        u, itT, s8 = serving[kind == "streaming"]
        U, I = s8.shape
        D = u.shape[1]
        idx = torch.empty((U, K), dtype=torch.int32, device=dev)
        vals = torch.empty((U, K), dtype=torch.float32, device=dev)
        if kind == "fused" and hasattr(lib["retrieval"], "fused_topk_smem_bytes"):
            return launch_topk(lib)
        if kind == "fused":  # the earlier launcher: 8 users' score rows a block
            fn = lib["retrieval"].fused_topk_retrieval_launch
            fn.argtypes = [P, P, P, INT, INT, INT, INT, P, P, P]
            rc = fn(u.data_ptr(), itT.data_ptr(), s8.data_ptr(), U, I, D, K,
                    idx.data_ptr(), vals.data_ptr(), stream)
        elif kind == "streaming":
            fn = lib["retrieval"].streaming_topk_retrieval_launch
            fn.argtypes = [P, INT, P, INT, P] + [INT] * 8 + [P] * 6
            rc = fn(uTp.data_ptr(), uTp.shape[1], itTp.data_ptr(), itTp.shape[1],
                    s8.data_ptr(), U, I, D, K, stream_tile(lib), parts, part_len, limit,
                    stream_workspace(lib),
                    part_idx.data_ptr(), part_val.data_ptr(), idx.data_ptr(),
                    vals.data_ptr(), stream)
        elif hasattr(lib["fusion_serve"], "fused_serve_smem_bytes"):  # tensor-core launcher
            flib = lib["fusion_serve"]
            got = fs.launch_kernel(flib, fs.bind(flib), serve_ops, seens, K)
            return got[0], got[1]
        else:  # the earlier launcher: A as CSR, f32 W
            u, itT, s8 = serve_old
            U, I = s8.shape
            idx = torch.empty((U, K), dtype=torch.int32, device=dev)
            vals = torch.empty((U, K), dtype=torch.float32, device=dev)
            fn = lib["fusion_serve"].fused_lgcnhs_serve_launch
            fn.argtypes = [P] * 7 + [INT] * 4 + [P] * 3
            rc = fn(u.data_ptr(), itT.data_ptr(), a_ptr.data_ptr(), a_col.data_ptr(),
                    a_val.data_ptr(), W.data_ptr(), s8.data_ptr(), U, I, D, K,
                    idx.data_ptr(), vals.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"{kind}: CUDA error {rc}")
        return idx, vals

    topk_ops = {}

    def launch_topk(lib):
        """One launch of the retrieval kernel of variant ``lib`` on the fused
        kind's inputs, planned from its own occupancy as the wrapper plans."""
        key = lib_key(lib)
        if key not in topk_ops:
            rlib = lib["retrieval"]
            fn = rt.bind_topk(rlib)
            resident = rlib.fused_topk_resident_blocks(K, limit)
            per_block = rlib.fused_topk_workspace_bytes(K, limit)
            U, I = seens.shape
            tparts, tlen = rt.topk_plan(U, I, resident, n_sms)
            forced = [int(o[6:]) for o in key.split(":")[1:] if o.startswith("parts=")]
            if forced:  # DIR:parts=N: N parts of whole steps
                tlen = -(-I // (forced[-1] * rt.STEP)) * rt.STEP
                tparts = -(-I // tlen)
            n = tparts * U * K if tparts > 1 else 0
            tws = (torch.empty(-(-U // rt.TOPK_USERS) * tparts * per_block // 4,
                               dtype=torch.int32, device=dev) if per_block else None)
            topk_ops[key] = (fn, rt._padded_t(ues), rt._padded_t(ies), tparts, tlen, tws,
                             torch.empty(n, dtype=torch.int32, device=dev),
                             torch.empty(n, dtype=torch.float32, device=dev),
                             torch.empty(U, dtype=torch.int64, device=dev))
            print(f"fused {key}: {resident} blocks an SM at k={K}, {tparts} parts of {tlen} "
                  "items", flush=True)
        fn, uT, itT, tparts, tlen, tws, pidx, pval, bound = topk_ops[key]
        U, I = seens.shape
        idx = torch.empty((U, K), dtype=torch.int32, device=dev)
        vals = torch.empty((U, K), dtype=torch.float32, device=dev)
        rc = fn(uT.data_ptr(), uT.shape[1], itT.data_ptr(), itT.shape[1],
                seens.view(torch.uint8).data_ptr(), U, I, uT.shape[0], K, tparts, tlen, limit,
                None if tws is None else tws.data_ptr(), bound.data_ptr(), pidx.data_ptr(),
                pval.data_ptr(), idx.data_ptr(), vals.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"fused: CUDA error {rc}")
        return idx, vals

    twins = {"fused": lambda: rt.fused_topk_retrieval_ref(ues, ies, seens, K),
             "streaming": lambda: rt.fused_topk_retrieval_ref(ueb, ieb, seenb, K),
             "serve": lambda: fs.fused_lgcnhs_serve_ref(ues, ies, A, W, seens, K),
             "dual": lambda: prop.dual_matmul_ref(R8, X, Y)}

    def median_ms(lib, kind, reps=10):
        return events_ms(lambda: launch(lib, kind), reps)

    def device_ms(lib, kind, n=20):
        """Device time of one launch's kernels, from torch.profiler."""
        from torch.profiler import ProfilerActivity, profile

        launch(lib, kind)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                launch(lib, kind)
            torch.cuda.synchronize()
        by_kernel = {}
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
                continue
            if not any(s in ev.key for s in ("dual_", "topk_kernel", "merge_kernel", "serve_kernel")):
                continue  # the outputs' allocation
            found = re.search(r"\w+_kernel", ev.key)
            name = found.group(0) if found else ev.key[:40]
            us = getattr(ev, "self_device_time_total", 0.0) or 0.0
            by_kernel[name] = by_kernel.get(name, 0.0) + us / 1e3 / n
        split[(lib_key(lib), kind)] = by_kernel
        return sum(by_kernel.values())

    split = {}

    def lib_key(lib):
        return next(v for v in variants if libs[v] is lib)

    for kind in kinds:
        have = [v for v in variants if SOURCES[kind] in libs[v]]
        if kind == "streaming":  # only copies from before the two kernels became one
            have = [v for v in have if hasattr(libs[v]["retrieval"], "streaming_workspace_bytes")]
        if kind == "fused":  # the earlier kernel keeps 8 users' score rows in a block
            have = [v for v in have if hasattr(libs[v]["retrieval"], "fused_topk_smem_bytes")
                    or 4 * 8 * (64 + seens.shape[1]) <= limit]
        if kind == "serve":  # the earlier kernel keeps 4 users' rows in a block
            have = [v for v in have if hasattr(libs[v]["fusion_serve"], "fused_serve_smem_bytes")
                    or 4 * 4 * (64 + W.shape[0]) <= limit]
        if not have:
            continue
        want = twins[kind]()
        for v in have:
            got = launch(libs[v], kind)
            torch.cuda.synchronize()
            if kind == "dual":
                diffs = [(a - b).abs().max() for a, b in zip(got, want)]
                rel = max(float(d / b.abs().max()) for d, b in zip(diffs, want))
                print(f"dual {v}: max |diff| to twin {max(float(d) for d in diffs):.3e}, "
                      f"relative to the output's scale {rel:.3e}", flush=True)
                continue
            (idx, vals), (wi, wv) = got, want
            print(f"{kind} {v}: index agreement with twin "
                  f"{float((idx == wi).float().mean()):.6f}, max |value diff| "
                  f"{float((vals - wv).abs().max()):.3e}", flush=True)
            if kind == "serve" and hasattr(libs[v]["fusion_serve"], "fused_serve_smem_bytes"):
                flib = libs[v]["fusion_serve"]
                wide = wide_w_problem(dev)
                gi, gv, _ = fs.launch_kernel(flib, fs.bind(flib), fs.serve_operands(*wide[:4]),
                                             wide[4], K)
                ti, tv = fs.fused_lgcnhs_serve_ref(*wide, K)
                print(f"serve {v}: W of 20 significant bits, bitwise equal to twin: "
                      f"{torch.equal(gi, ti) and torch.equal(gv, tv)} "
                      f"({int((gi != ti).sum())} index, {int((gv != tv).sum())} value mismatches)",
                      flush=True)
        times = {v: [] for v in have}
        dev_times = {v: [] for v in have}
        for _ in range(3):
            for v in have + have[::-1]:
                times[v].append(median_ms(libs[v], kind))
                dev_times[v].append(device_ms(libs[v], kind))
        for v in have:
            print(f"{kind} {v} ms: {' '.join(f'{t:.4f}' for t in times[v])}; device ms: "
                  f"{' '.join(f'{t:.4f}' for t in dev_times[v])}; by kernel "
                  f"{ {k: round(t, 4) for k, t in split[(v, kind)].items()} } [{smi}]",
                  flush=True)
        if kind == "serve":
            serve_baselines(ues, ies, A, W, seens, smi)
        if kind == "fused":
            retrieval_baselines(ues, ies, seens, smi)


def retrieval_baselines(ue, ie, seen, smi):
    """Retrieval's bound on these inputs (chip_smoke.py's: each input read
    once, the lists written once; 2 U I D operations at the f32 peak), and
    the ms of the plain twin and of the matmul+topk composition on the same
    inputs (median of 3 CUDA-event timings; device ms from torch.profiler,
    every kernel of a call)."""
    U, D = ue.shape
    I = ie.shape[0]
    t_bytes = (4 * (U * D + I * D) + U * I + 8 * U * K) / PEAK_BYTES_PER_S
    t_ops = 2 * U * I * D / PEAK_F32_FLOP_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"fused bound U={U} I={I} D={D} k={K}: {max(t_bytes, t_ops) * 1e3:.4f} ms by {by} "
          f"[{smi}]", flush=True)

    def composition():
        return torch.topk(torch.matmul(ue, ie.T).masked_fill_(seen, -1024.0), K, dim=1)

    for name, fn in (("matmul+topk", composition),
                     ("twin", lambda: rt.fused_topk_retrieval_ref(ue, ie, seen, K))):
        ms = events_ms(fn)
        print(f"fused {name} U={U} I={I}: {ms:.4f} ms; device {all_device_ms(fn):.4f} ms [{smi}]",
              flush=True)
        torch.cuda.empty_cache()


def serve_baselines(ue, ie, A, W, seen, smi):
    """Fused serving's bound on these inputs (chip_smoke.py's: each input
    read once, the lists written once; 2 nnz(A) I + 2 U I D + U I
    operations at the f32 peak), and the ms of the plain twin and of the
    matmul+topk composition (median of 3 CUDA-event timings; device ms
    from torch.profiler, every kernel of a call)."""
    U, D = ue.shape
    I = ie.shape[0]
    nnz = int((A != 0).sum())
    t_bytes = (4 * (U * D + I * D + U * I + I * I) + U * I + 8 * U * K) / PEAK_BYTES_PER_S
    t_ops = (2 * nnz * I + 2 * U * I * D + U * I) / PEAK_F32_FLOP_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"serve bound U={U} I={I} D={D} k={K} nnz(A)={nnz}: {max(t_bytes, t_ops) * 1e3:.4f} ms "
          f"by {by} (bytes {t_bytes * 1e3:.4f} ms, operations {t_ops * 1e3:.4f} ms); dense tile "
          f"work of the design 3 x 2 U I^2 = {6 * U * I * I / 1e12:.2f} TFLOP [{smi}]", flush=True)

    def composition():
        fused = torch.matmul(ue, ie.T) * torch.matmul(A, W)
        return torch.topk(fused.masked_fill_(seen, fs.EXCLUDED), K, dim=1)

    for name, fn in (("matmul+topk", composition),
                     ("twin", lambda: fs.fused_lgcnhs_serve_ref(ue, ie, A, W, seen, K))):
        ms = events_ms(fn)
        print(f"serve {name} U={U} I={I}: {ms:.4f} ms; device {all_device_ms(fn):.4f} ms [{smi}]",
              flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kinds", default="fused,streaming,serve,dual")
    parser.add_argument("--k", type=int, default=K)
    parser.add_argument("--items", type=int, default=0)
    parser.add_argument("variants", nargs="*")
    args = parser.parse_args()
    if not args.variants or not torch.cuda.is_available():
        print(__doc__)
        sys.exit(2)
    K, ITEMS = args.k, args.items
    main(args.variants, [k for k in args.kinds.split(",") if k])

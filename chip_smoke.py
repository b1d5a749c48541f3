#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``lgcnhs_tpu_torch``): the quickest
proof that the port builds, trains and serves on an NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository beside this file; imports
neither JAX nor ``lgcnhs_tpu``. Phases:

1. Environment: the card's name and power limit.
2. Build: every CUDA source of the port, all nvcc processes at once.
3. Kernels against their plain twins (the checks of ``tests/tpu_smoke.py``
   on the card): identical indices and values on inputs whose scores are
   exact in f32, tie-equivalence (agreement >= 0.98, mismatched slots within
   5e-4 relative under an f64 reference) on continuous inputs. Retrieval
   (one kernel in place of both Pallas kernels) at k=1/100/1000 at the
   ML-100K (943 x 1682) and ML-1M (6040 x 3706) shapes, at k=10/100 at
   384 x 896, at k=100/1000 over 50k items and at D=1024, and at
   k=1/128/129/407/408/1000/3000 over catalogs off its 128-item steps (the
   edges of its in-register merges and of its lists in shared memory;
   running and merge lists in device memory), with sub-sentinel users and
   a second launch bitwise equal to the first. Fused serving
   with a fewer-than-k-unseen user and a user with no interactions (a
   second launch bitwise equal), at the slice's 6040 x 3706 x 64 too, also
   over 20,000 items (past the earlier kernel's shared-memory cap) at
   k=1/100/1000, with a W of 20 significant bits (which every bf16 part of
   W must carry), and ragged shapes (partial user blocks, k == I, I below a
   warp, k above 128, an A that is not exact in bf16). Each kernel's block
   memory against its Python sizing (and the retrieval kernel's blocks an
   SM as its launcher reports them), the retrieval route,
   the fused serving kernel's bf16 split of A and W against the plain
   split and its flag for an A not exact in bf16. ``dual_matmul``
   (training) for its four
   dtype pairs on the slice's 6040 x 3706 train incidence at D=64, forward
   and backward: bitwise equal on dyadic inputs, within 1e-5 of each
   output's scale on continuous ones (f32 sums in another order; a bf16
   gradient also within one bf16 rounding), two launches bitwise equal;
   and on ragged shapes (U, I off the tiles and off 16, I below a warp,
   D 3/8/20/64/128, a skewed incidence); its shared-memory guard against
   the launcher's own figure.
4. The serving slice end to end through ``lgcnhs_tpu_torch.cli.retrieve``
   (``--env prod``, k=100) with seeded LightGCNOpti checkpoints:
   SpreadLightGCNOpti (fused serving) and LightGCNOpti (fused retrieval)
   at ML-1M scale and over a 49,410-item catalog, and LightGCNOpti over
   that catalog at k=1000 (running lists in device memory). Float64
   checkpoints at ML-1M for both models: served at f64 on the card by the
   plain chain, no kernel launched, identical to that chain run directly
   and to it on the CPU (tie-equivalent for fused serving, whose f32
   product F sums in another order there). Then the training slice: the
   same CLI on an empty workdir trains LightGCNOpti for 1000 epochs through
   the ``dual_matmul`` kernel (6 launches a step) and serves
   SpreadLightGCNOpti from the checkpoint it wrote. Launch counts (and the
   counts of the second kernels: the split-K sum of ``dual_matmul``, the
   catalog parts' merges) are zeroed just before each path and read just
   after, and each run is checked to have gone through its kernel alone.
   Every output is checked against the plain chain, the training history for finite values and a
   falling loss. Last, 20 epochs on the kernel route and on the twin route
   from one seed, compared within the stated tolerance.
5. Timings at the main path's shapes: kernel, plain twin, and the nearest
   library composition (torch.matmul + torch.topk, two bf16 torch.matmul
   for ``dual_matmul``; no single PyTorch call computes these functions, so
   ``library_ms`` is null), medians of CUDA-event timings; every kernel's
   device ms and its composition's from ``torch.profiler`` and its share of
   the bound (fused serving: also its dense floor, the tensor-core work of
   its design at the bf16 peak); retrieval also over the 49,410-item
   catalog at k=100 and k=1000; the train step's ms and examples/s over a
   synchronized steady window, its device-busy ms and idle share, and its
   device time by kernel from ``torch.profiler``.

Prints one PASS/FAIL line per check, then (all passed) the kernel JSON line,
the ``nvidia-smi`` name/power-limit line, and the final
``{"ok": true, "device": ...}`` line. Any failure exits non-zero and prints
no result.
"""
from __future__ import annotations

import csv
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
K_SLICE = 100
K_LARGE = 1000  # a long list over the large catalog: running lists in device memory
BIG_CATALOG = 50_000  # tests/tpu_smoke.py's streaming size (49,410 items kept)
AGREEMENT_MIN = 0.98
GAP_MAX = 5e-4
# NVIDIA H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (every kernel here is full f32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12  # dense tensor-core rate, dual_matmul's operand type
TRAIN_EPOCHS = 1000
TWIN_EPOCHS = 20
DUAL_REL_TOL = 1e-5
BF16_ULP = 2.0 ** -7  # bf16 spacing: at most 2^-7 of a value
# Kernel route vs twin route over TWIN_EPOCHS (phase 4). Their f32 sums
# differ in order, so a bf16 cast between layers can round one step apart
# (2^-8 relative on an element); that can flip a small gradient's sign, and
# Adam then moves the element up to ~2 lr a step apart (0.04 over 20 steps
# at lr 1e-3). Measured: table gaps 1.9e-5 and 8.7e-6 at table scale 3.0,
# losses equal to 5 decimals (PERF.md). The tolerances sit 50x above
# the measured gaps, far below the worst case.
TWIN_LOSS_TOL = 1e-4
TWIN_TABLE_TOL = 1e-3


class Checks:
    def __init__(self):
        self.failures = []

    def __call__(self, name, ok, detail=""):
        print(f"[{'PASS' if ok else 'FAIL'}] {name}" + (f" -- {detail}" if detail else ""),
              flush=True)
        if not ok:
            self.failures.append(name)
        return ok

    def guard(self, name, fn, *args):
        """Runs one check group; an exception fails it and is printed."""
        try:
            return fn(*args)
        except Exception:  # a failed phase is reported, the others still run
            traceback.print_exc()
            self(name, False, "raised")
            return None


def tie_equivalence(torch, want_idx, got_idx, ref):
    """(agreement, max relative gap over mismatched slots under ``ref``)."""
    want, got = want_idx.long(), got_idx.long()
    mism = want != got
    agreement = 1.0 - mism.double().mean().item()
    if not bool(mism.any()):
        return agreement, 0.0
    w, g = ref.gather(1, want)[mism], ref.gather(1, got)[mism]
    gap = ((w - g).abs() / (torch.maximum(w.abs(), g.abs()) + 1e-5)).max().item()
    return agreement, gap


def compare(torch, check, name, got, want, ref=None):
    """Exact (ref None): identical indices and values. Else tie-equivalence."""
    gi, gv = got
    wi, wv = want
    if ref is None:
        same_i, same_v = torch.equal(gi, wi), torch.equal(gv, wv)
        return check(name + " == twin (exact)", same_i and same_v,
                     f"{int((gi != wi).sum())} index and {int((gv != wv).sum())} value "
                     "mismatches")
    agreement, gap = tie_equivalence(torch, wi, gi, ref)
    return check(name + " tie-equivalent to twin",
                 agreement >= AGREEMENT_MIN and gap <= GAP_MAX,
                 f"agreement {agreement:.6f}, mismatched-slot max relative gap {gap:.3e}")


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def median_ms(torch, fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes, flops, peak_flops=PEAK_F32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        from lgcnhs_tpu_torch import config as tcfg
        from lgcnhs_tpu_torch.cli import retrieve
        from lgcnhs_tpu_torch.data.datasets import load_dataset
        from lgcnhs_tpu_torch.data.graph import (
            build_graph, interaction_matrix, pos_bool_matrix, unique_edges,
        )
        from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, init_lightgcn_opti
        from lgcnhs_tpu_torch.models.recommenders import checkpoint_path
        from lgcnhs_tpu_torch.ops.cuda import build
        from lgcnhs_tpu_torch.ops.cuda import fusion_serve as fs
        from lgcnhs_tpu_torch.ops.cuda import propagation as prop
        from lgcnhs_tpu_torch.ops.cuda import retrieval as rt
        from lgcnhs_tpu_torch.ops.diffusion import general_spreading_matrix, hybrid_transfer
        from lgcnhs_tpu_torch.ops.topk import (
            MASK_VALUE, masked_topk, retrieval_route, select_topk,
        )
        from lgcnhs_tpu_torch.train import trainer
        from lgcnhs_tpu_torch.train.trainer import load_checkpoint, save_checkpoint
    except ImportError as e:
        print(f"chip_smoke: the lgcnhs_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    check = Checks()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. environment ---------------------------------------------------
    smi = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    print(f"[env] nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| device {kind} x{torch.cuda.device_count()}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build(verbose=True)
    limit = build.device_smem_limit("retrieval", dev)
    print(f"[build] {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s; "
          f"block shared-memory limit {limit} B", flush=True)

    gen = np.random.default_rng(SEED)

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def dyadic(shape, lo=-4, hi=5):
        return (gen.integers(lo, hi, shape) / 8).astype(np.float32)

    def normal(shape, scale):
        return (gen.standard_normal(shape) * scale).astype(np.float32)

    def sub_sentinel(ue, ie, seen):
        """Users 0 and 1 score below -1024 everywhere; user 1 has seen items,
        which then outrank every unseen one."""
        ie[:, 0] = 1.0 + np.abs(ie[:, 0])
        ue[:2] = 0.0
        ue[:2, 0] = -3000.0
        seen[:2] = False
        seen[1, [5, 17, 250]] = True

    def retrieval_ref64(ue, ie, seen):
        s = ue.double() @ ie.double().T
        return torch.where(seen, torch.full_like(s, MASK_VALUE), s)

    def serve_ref64(ue, ie, A, W, seen):
        """f64 fused scores; F summed over row blocks of W, so no f64 copy of
        all of W is made (9.8 GB in f32 at 49,410 items)."""
        f = torch.zeros((A.shape[0], W.shape[1]), dtype=torch.float64, device=A.device)
        step = max(1, (1 << 28) // W.shape[1])
        for l0 in range(0, W.shape[0], step):
            f += A[:, l0:l0 + step].double() @ W[l0:l0 + step].double()
        f *= ue.double() @ ie.double().T
        return f.masked_fill_(seen, fs.EXCLUDED)

    # -- 3. kernels against their twins ----------------------------------
    def retrieval_checks(U, I, D, ks, label):
        """The retrieval kernel against the twin at each k, dyadic (bitwise)
        and continuous (tie-equivalent), with the sub-sentinel users and a
        second launch bitwise equal to the first."""
        for exact in (True, False):
            ue = dyadic((U, D)) if exact else normal((U, D), 0.3)
            ie = dyadic((I, D)) if exact else normal((I, D), 0.3)
            seen = gen.random((U, I)) < 0.05
            sub_sentinel(ue, ie, seen)
            ue, ie, seen = cuda(ue), cuda(ie), cuda(seen)
            ref = None if exact else retrieval_ref64(ue, ie, seen)
            for k in ks:
                want = rt.fused_topk_retrieval_ref(ue, ie, seen, k)
                got = rt.fused_topk_retrieval(ue, ie, seen, k)
                again = rt.fused_topk_retrieval(ue, ie, seen, k)
                torch.cuda.synchronize()
                flavor = f"retrieval {label} k={k} {'dyadic' if exact else 'continuous'}"
                compare(torch, check, flavor, got, want, ref)
                sub = got[0][:2]
                check(f"{flavor}: sub-sentinel users get real ids",
                      bool(((sub >= 0) & (sub < I)).all())
                      and got[0][1, :3].tolist() == [5, 17, 250][:min(k, 3)])
                check(f"{flavor}: second launch bitwise equal",
                      torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
            del ref

    def list_checks(U, I, D, ks):
        """The retrieval kernel at each k over a catalog that is not a whole
        number of 128-item steps: k = 128 (the largest k merged in
        registers) and 129 (merged through memory), 407 (the largest k whose
        lists fit the block's shared memory) and 408 (running lists in
        device memory), 1000 and 3000 (merge lists in device memory too);
        dyadic, with the sub-sentinel users and a second launch bitwise
        equal to the first."""
        ue, ie = dyadic((U, D)), dyadic((I, D))
        seen = gen.random((U, I)) < 0.05
        sub_sentinel(ue, ie, seen)
        ue, ie, seen = cuda(ue), cuda(ie), cuda(seen)
        for k in ks:
            label = (f"retrieval {U}x{I}x{D} k={k} (workspace "
                     f"{rt.topk_block_bytes(k, limit)[1]} B a block)")
            got = rt.fused_topk_retrieval(ue, ie, seen, k)
            again = rt.fused_topk_retrieval(ue, ie, seen, k)
            torch.cuda.synchronize()
            compare(torch, check, label, got, rt.fused_topk_retrieval_ref(ue, ie, seen, k))
            check(f"{label}: second launch bitwise equal",
                  torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
            sub = got[0][:2]
            check(f"{label}: users scoring below -1024 everywhere get real ids",
                  bool(((sub >= 0) & (sub < I)).all())
                  and got[0][1, :3].tolist() == [5, 17, 250][:min(k, 3)])

    def serve_checks(U, I, D, ks, label, A_real=None):
        """Fused serving against its twin at each k, dyadic and continuous,
        with a second launch bitwise equal to the first; user 0 has three
        unseen items (fewer than k: its seen items follow, lowest id first),
        user 1 none seen (every fused score +-0). W is drawn on the card."""
        wgen = torch.Generator(device=dev).manual_seed(SEED)
        for exact in (True, False):
            ue = dyadic((U, D)) if exact else normal((U, D), 0.3)
            ie = dyadic((I, D)) if exact else normal((I, D), 0.3)
            W = (torch.randint(0, 4, (I, I), generator=wgen, device=dev).float() / 8 if exact
                 else torch.rand((I, I), generator=wgen, device=dev) * 0.01)
            A = A_real if A_real is not None else (gen.random((U, I)) < 0.04).astype(np.float32)
            A = A.copy()
            A[0] = 1.0
            A[0, [3, 50, 121]] = 0.0  # user 0: three unseen items, fewer than k
            A[1] = 0.0  # user 1: no interactions, every fused score is +-0
            ue, ie, A = cuda(ue), cuda(ie), cuda(A)
            seen = A > 0
            ref = None if exact else serve_ref64(ue, ie, A, W, seen)
            tail = [j for j in range(I) if j not in (3, 50, 121)]
            for k in ks:
                flavor = f"fused serve {label} k={k} {'dyadic' if exact else 'continuous'}"
                want = fs.fused_lgcnhs_serve_ref(ue, ie, A, W, seen, k)
                got = fs.fused_lgcnhs_serve(ue, ie, A, W, seen, k)
                again = fs.fused_lgcnhs_serve(ue, ie, A, W, seen, k)
                torch.cuda.synchronize()
                compare(torch, check, flavor, got, want, ref)
                check(f"{flavor}: second launch bitwise equal",
                      torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
                row = got[0][0].tolist()
                check(f"{flavor}: fewer-than-k-unseen user gets distinct ids, its seen items "
                      "lowest id first",
                      len(set(row)) == k and set(row[:3]) == {3, 50, 121}.intersection(row[:3])
                      and len(set(row[:3])) == min(k, 3) and row[3:] == tail[:max(0, k - 3)],
                      f"{row[:6]}")
                check(f"{flavor}: user with no interactions scores +-0 as the twin ranks them",
                      bool((got[1][1] == 0).all()) and torch.equal(got[0][1], want[0][1]))
            del W

    def serve_w_bits_checks(U, I, D, ks, label):
        """Fused serving with a W of 20 significant bits, in [0.5, 1): one
        bf16 part of W holds 8 of them, two hold 16, so a kernel that drops
        a part of W is off by up to 2^-8 or 2^-16 of F. A has 12 items a
        user, so each F sum (12 multiples of 2^-20 below 16) is exact in
        f32 in any order, and G*F is identical to the twin's."""
        wgen = torch.Generator(device=dev).manual_seed(SEED + 1)
        W = torch.randint(1 << 19, 1 << 20, (I, I), generator=wgen, device=dev).float() / (1 << 20)
        A = np.zeros((U, I), np.float32)
        np.put_along_axis(A, gen.random((U, I)).argsort(axis=1)[:, :12], 1.0, axis=1)
        ue, ie, A = cuda(dyadic((U, D))), cuda(dyadic((I, D))), cuda(A)
        for k in ks:
            compare(torch, check, f"fused serve {label} k={k} W of 20 significant bits",
                    fs.fused_lgcnhs_serve(ue, ie, A, W, A > 0, k),
                    fs.fused_lgcnhs_serve_ref(ue, ie, A, W, A > 0, k))

    def edge_checks():
        """Ragged shapes: partial user blocks, D off the load batch, k == I,
        I below a warp, k above 128."""
        for U, I, D, k in ((37, 300, 20, 10), (13, 40, 3, 40), (9, 5, 8, 5), (70, 1000, 64, 200)):
            label = f"edge U={U} I={I} D={D} k={k}"
            ue, ie = cuda(dyadic((U, D))), cuda(dyadic((I, D)))
            seen = cuda(gen.random((U, I)) < 0.2)
            want = rt.fused_topk_retrieval_ref(ue, ie, seen, k)
            compare(torch, check, f"retrieval {label}",
                    rt.fused_topk_retrieval(ue, ie, seen, k), want)
            mask = gen.random((U, I)) < 0.2
            A = cuda(mask.astype(np.float32))
            W = cuda(dyadic((I, I), 0, 4))
            compare(torch, check, f"fused serve {label}",
                    fs.fused_lgcnhs_serve(ue, ie, A, W, A > 0, k),
                    fs.fused_lgcnhs_serve_ref(ue, ie, A, W, A > 0, k))
            # an A that is not exact in bf16 (12 significand bits) goes in as
            # three parts; its products and sums are still exact in f32
            A12 = cuda((mask * gen.integers(1, 4096, (U, I)) / 4096).astype(np.float32))
            compare(torch, check, f"fused serve {label} A not exact in bf16",
                    fs.fused_lgcnhs_serve(ue, ie, A12, W, A12 > 0, k),
                    fs.fused_lgcnhs_serve_ref(ue, ie, A12, W, A12 > 0, k))

    def dual_case(label, R, X, Y, exact):
        """dual_matmul against its twin, forward and backward (cotangents
        through torch.autograd.grad), and against a second launch."""
        got, again = prop.dual_matmul(R, X, Y), prop.dual_matmul(R, X, Y)
        want = prop.dual_matmul_ref(R, X, Y)
        torch.cuda.synchronize()
        check(f"dual_matmul {label}: two launches bitwise equal",
              all(torch.equal(a, b) for a, b in zip(got, again)))
        gu, gi = (cuda(dyadic(tuple(t.shape)) if exact else normal(tuple(t.shape), 1.0))
                  for t in want)
        grads = []
        for fn in (prop.dual_matmul, prop.dual_matmul_ref):
            Xg, Yg = X.detach().requires_grad_(True), Y.detach().requires_grad_(True)
            grads.append(torch.autograd.grad(fn(R, Xg, Yg), (Xg, Yg), (gu, gi)))
        torch.cuda.synchronize()
        # a bf16 gradient is an f32 sum rounded to bf16: f32 sums in another
        # order may round one bf16 step (<= 2^-7 of the value) apart
        ulp_bwd = BF16_ULP if X.dtype == torch.bfloat16 else 0.0
        for what, g, w, ulp in (("forward", got, want, 0.0),
                                ("backward", grads[0], grads[1], ulp_bwd)):
            if exact:
                diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(g, w))
                check(f"dual_matmul {label} {what} == twin (bitwise)",
                      all(torch.equal(a, b) for a, b in zip(g, w)), f"max |diff| {diff:.3e}")
                continue
            err = max(((a.float() - b.float()).abs() - ulp * b.float().abs()).max().item()
                      / max(b.float().abs().max().item(), 1e-30) for a, b in zip(g, w))
            check(f"dual_matmul {label} {what} within {DUAL_REL_TOL:g} of the twin's scale",
                  err <= DUAL_REL_TOL, f"max relative error {err:.3e}")

    def dual_checks(R8):
        """The four dtype pairs on the slice's train incidence (float R:
        its pattern with dyadic or normal values), then ragged shapes."""
        U, I = R8.shape
        names = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
        for rdt, edt in prop.PAIRS:
            for exact in (True, False):
                vals = dyadic if exact else (lambda shape: normal(shape, 1.0))
                R = R8 if rdt == torch.int8 else (R8.float() * cuda(vals((U, I)))).to(rdt)
                dual_case(f"{U}x{I}x64 {names[rdt]}/{names[edt]} "
                          f"{'dyadic' if exact else 'continuous'}", R,
                          cuda(vals((I, 64))).to(edt), cuda(vals((U, 64))).to(edt), exact)
        # ragged shapes: U, I off the 64-tile and off 16, I below a warp,
        # D 3/20 (bf16 rows not a whole number of 16-byte copies) and 8/64/128;
        # the last, skewed: hot items every user has and a user with every item
        for U2, I2, D2 in ((37, 300, 8), (13, 20, 64), (70, 1000, 128), (500, 31, 64), (1, 1, 8),
                           (130, 333, 3), (200, 1001, 20), (700, 150, 64)):
            mask = gen.random((U2, I2)) < 0.3
            if (U2, I2) == (700, 150):
                mask[:, :5] = True
                mask[3] = True
            mask = cuda(mask)
            for rdt, edt in prop.PAIRS:
                R = mask.to(torch.int8) if rdt == torch.int8 else \
                    (mask.float() * cuda(dyadic((U2, I2)))).to(rdt)
                dual_case(f"edge U={U2} I={I2} D={D2} {names[rdt]}/{names[edt]}", R,
                          cuda(dyadic((I2, D2))).to(edt), cuda(dyadic((U2, D2))).to(edt), True)
        # R as a view of a wider buffer whose entries past column I are junk
        # (NaN for bf16, negative bytes for int8): read in place, never counted
        U2, I2 = 130, 333
        mask = cuda(gen.random((U2, I2)) < 0.3)
        for rdt, junk in ((torch.bfloat16, float("nan")), (torch.int8, -77)):
            R = mask.to(rdt) if rdt == torch.int8 else \
                (mask.float() * cuda(dyadic((U2, I2)))).to(rdt)
            wide = torch.full((U2, 352), junk, dtype=rdt, device=R.device)
            wide[:, :I2] = R
            view = wide[:, :I2]
            Xv, Yv = (cuda(dyadic((n, 20))).to(torch.bfloat16) for n in (I2, U2))
            got, want = prop.dual_matmul(view, Xv, Yv), prop.dual_matmul_ref(R, Xv, Yv)
            torch.cuda.synchronize()
            check(f"dual_matmul {names[rdt]} R view with junk past column I == twin (bitwise)",
                  prop.rows_aligned(view) and all(torch.equal(a, b) for a, b in zip(got, want)))

    print("[phase 3] kernels against their twins", flush=True)
    check.guard("edge shapes", edge_checks)
    ds_cfg = tcfg.load_config(env="prod", dataset="movielens1m", model="LightGCNOpti")
    splits, feats_u, feats_i = load_dataset(ds_cfg)
    graph = build_graph(splits)
    R8_slice, du_slice, di_slice = trainer.device_binary_factors(
        graph.n_users, graph.n_items, graph.train, dev)
    A_slice = interaction_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
    tlib = rt._topk_launcher()[0]
    mism = [(k, rt.topk_block_bytes(k, limit),
             (tlib.fused_topk_smem_bytes(k, limit), tlib.fused_topk_workspace_bytes(k, limit)))
            for k in (1, 100, 128, 129, 146, 147, 407, 408, 1000, 3000)]
    mism = [x for x in mism if tuple(x[1]) != tuple(x[2])]
    check("retrieval guard: topk_block_bytes equals the launcher's shared memory and workspace",
          not mism, f"{mism}")
    resident = {k: tlib.fused_topk_resident_blocks(k, limit) for k in (1, 100, 147)}
    check("retrieval kernel: two blocks (16 warps) an SM at k=100, as shared memory allows",
          resident[100] == 2 and resident[147] == 1, f"resident blocks {resident}")
    check("route: the kernel for float32 tables, the plain chain for float64",
          [retrieval_route("cuda", t) for t in (torch.float32, torch.float64)]
          == ["kernel", "plain"])
    check("dual_matmul guard: D=64 and D=128 fit, D=129 does not",
          prop.fits_smem_dual(64, limit) and prop.fits_smem_dual(128, limit)
          and not prop.fits_smem_dual(129, limit) and prop.fits_dual(64, dev)
          and prop.fits_dual(128, dev) and not prop.fits_dual(129, dev))
    plib = build.load_library("propagation")
    smem_pairs = [(r, e, d) for r, e in prop.PAIRS for d in (3, 20, 64, 128)]
    mism = [(str(r), str(e), d, prop.smem_bytes(d, r, e),
             plib.dual_matmul_smem_bytes(prop._CODES[r], prop._CODES[e], d))
            for r, e, d in smem_pairs
            if prop.smem_bytes(d, r, e) != plib.dual_matmul_smem_bytes(prop._CODES[r],
                                                                        prop._CODES[e], d)]
    check("dual_matmul guard: smem_bytes equals the launcher's shared memory", not mism,
          f"{mism}")
    slib = fs._launcher()[0]
    sizes = [(k, na, fs.serve_block_bytes(k, na, limit),
              (slib.fused_serve_smem_bytes(k, na, limit),
               slib.fused_serve_workspace_bytes(k, na, limit)))
             for k in (1, 100, 108, 109, 1000, 1816, 1817, 3000) for na in (1, 3)]
    mism = [x for x in sizes if tuple(x[2]) != tuple(x[3])]
    check("fused serve: serve_block_bytes equals the launcher's shared memory and workspace",
          not mism, f"{mism}")
    xs = torch.cat([torch.randn((300, 1000), device=dev) * 1e3,
                    torch.rand((300, 1000), device=dev) * 1e-20])
    binary = (torch.rand((300, 1000), device=dev) < 0.3).float()
    for x0, n, tr in ((xs, 1, False), (xs, 3, False), (xs, 3, True), (binary, 1, False)):
        x = x0.T if tr else x0
        flag = torch.zeros(1, dtype=torch.int32, device=dev) if n == 1 else None
        on_card = fs.split_on_card(x0, n, 608 if tr else 1008, transpose=tr, inexact=flag)
        plain = fs.bf16_parts(x, n, 608 if tr else 1008)
        back = on_card.float().sum(0)[:, :x.shape[1]] if n == 3 else None
        what = "a 0/1 matrix" if x0 is binary else "x^T" if tr else "x"
        check(f"bf16 split ({n} part{'s' if n > 1 else ''} of {what}) on the "
              "card == its plain version (bitwise)"
              + (", and sums back to the input" if n == 3 else
                 f", flagged {'exact' if x0 is binary else 'not exact'} in bf16"),
              torch.equal(on_card, plain) and (back is None or torch.equal(back, x))
              and (flag is None or int(flag) == int(x0 is not binary)))
    check.guard("dual_matmul", dual_checks, R8_slice)
    check.guard("retrieval 384x896", retrieval_checks, 384, 896, 64, (10, 100), "384x896")
    check.guard("retrieval ML-100K shape", retrieval_checks, 943, 1682, 64, (1, 100, 1000),
                "943x1682x64")
    check.guard("retrieval slice", retrieval_checks, graph.n_users, graph.n_items, 64,
                (1, 100, 1000), f"{graph.n_users}x{graph.n_items}x64")
    check.guard("retrieval 50k", retrieval_checks, 384, BIG_CATALOG, 64, (100, 1000),
                f"384x{BIG_CATALOG}")
    check.guard("retrieval lists", list_checks, 300, 1111, 64, (1, 128, 129, 407, 408, 1000))
    check.guard("retrieval k=3000", list_checks, 40, 3500, 16, (3000,))
    check.guard("retrieval D=1024", retrieval_checks, 128, 16_384, 1024, (100,),
                "128x16384 D=1024")
    check.guard("serve 384x896", serve_checks, 384, 896, 64, (10, 100), "384x896")
    check.guard("serve slice", serve_checks, graph.n_users, graph.n_items, 64, (10, 100),
                f"{graph.n_users}x{graph.n_items}x64", A_slice)
    check.guard("serve past the earlier cap", serve_checks, 384, 20_000, 64, (1, 100, 1000),
                "384x20000")
    check.guard("serve W of 20 bits", serve_w_bits_checks, 384, 896, 64, (10, 100), "384x896")
    check.guard("serve W of 20 bits, slice", serve_w_bits_checks, graph.n_users, graph.n_items,
                64, (100,), f"{graph.n_users}x{graph.n_items}x64")
    del A_slice

    # -- 4. the serving slice end to end ----------------------------------
    print("[phase 4] cli/retrieve end to end", flush=True)
    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "artifacts"))
    ml1m = ["--dataset", "movielens1m", "--env", "prod"]
    big = ["--dataset", "synthetic", "--env", "prod", "--users", "6040",
           "--items", str(BIG_CATALOG), "--interactions", "1000209"]
    # (model, arguments, k): k=100 is the prod preset's; a list of 1000 over
    # the large catalog keeps its running lists in device memory
    runs = [("SpreadLightGCNOpti", ml1m, K_SLICE), ("LightGCNOpti", ml1m, K_SLICE),
            ("LightGCNOpti", big, K_SLICE), ("SpreadLightGCNOpti", big, K_SLICE),
            ("LightGCNOpti", big, K_LARGE)]

    def make_cell(model, args, k, workdir, dtype=torch.float32):
        """(config, graph, seeded random tables) of one run, its checkpoint
        written where cli/retrieve looks for it."""
        over = {"k": k}
        if args is big:
            over.update(synthetic_users=6040, synthetic_items=BIG_CATALOG,
                        synthetic_interactions=1_000_209)
        cfg = tcfg.load_config(env="prod", dataset=args[1], model=model, workdir=workdir,
                               overrides=over)
        splits, uf, itf = load_dataset(cfg)
        g = build_graph(splits)
        params = init_lightgcn_opti(torch.Generator().manual_seed(SEED), uf, itf, 64)
        params = LightGCNParams(*(t.to(dtype) for t in params))
        os.makedirs(cfg.model_path, exist_ok=True)
        save_checkpoint(checkpoint_path(cfg), params)
        return cfg, g, params

    cells = {(model, args[1], k): make_cell(model, args, k, work) for model, args, k in runs}

    kernels = {"fused_topk_retrieval": rt.fused_topk_retrieval,
               "fused_lgcnhs_serve": fs.fused_lgcnhs_serve}
    for fn in kernels.values():
        fn.launches = 0
        fn.merge_launches = 0
    fs.fused_lgcnhs_serve.split_launches = 0
    outputs, run_launches = [], []
    for model, args, k in runs:
        t0 = time.perf_counter()
        before = {name: fn.launches for name, fn in kernels.items()}
        rec = retrieve.main(["--device", "cuda", "--workdir", work, "--model", model, *args,
                             "--k", str(k)])
        outputs.append(rec)
        run_launches.append({name: fn.launches - before[name] for name, fn in kernels.items()})
        print(f"[phase 4] {model} {args[1]} k={k}: {rec.shape} in "
              f"{time.perf_counter() - t0:.2f} s, launches {run_launches[-1]}", flush=True)
    launches = {name: fn.launches for name, fn in kernels.items()}
    merges = {name: fn.merge_launches for name, fn in kernels.items()}
    serve_splits = fs.fused_lgcnhs_serve.split_launches
    print(f"[phase 4] launches {launches}, merges {merges}, fused serve split {serve_splits}",
          flush=True)
    for name, n in launches.items():
        check(f"main path launched {name}", n > 0, f"{n} launches")
    check("main path launched the retrieval kernel's merge over its catalog parts with each "
          "call", merges["fused_topk_retrieval"] == launches["fused_topk_retrieval"], f"{merges}")
    check("main path launched the fused serve's merge and its bf16 split with each call",
          merges["fused_lgcnhs_serve"] == launches["fused_lgcnhs_serve"]
          and serve_splits == 2 * launches["fused_lgcnhs_serve"],
          f"{merges['fused_lgcnhs_serve']} merges, {serve_splits} splits")
    for (model, args, k), n in zip(runs, run_launches):
        want = "fused_lgcnhs_serve" if model == "SpreadLightGCNOpti" else "fused_topk_retrieval"
        check(f"cli/retrieve {model} {args[1]} k={k} served through {want} alone",
              n == {name: int(name == want) for name in kernels}, f"{n}")

    timing_inputs = {}

    def output_checks(model, dataset, cfg, g, params, rec, timing_key):
        """The served (U, k) lists against the plain chain."""
        k = cfg.k
        label = f"cli/retrieve {model} {dataset} ({g.n_users}x{g.n_items}, k={k})"
        seen = cuda(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val))
        ue, ie = params.user_emb.to(dev), params.item_emb.to(dev)
        got = cuda(rec)
        check(f"{label} shape and id range", tuple(rec.shape) == (g.n_users, k)
              and bool(((got >= 0) & (got < g.n_items)).all()))
        enough = (~seen).sum(dim=1) >= k
        hits = seen.gather(1, got.long())[enough].any(dim=1)
        check(f"{label} no seen item for users with >= {k} unseen", not bool(hits.any()),
              f"{int(hits.sum())} users violate")
        if model == "LightGCNOpti":
            want = masked_topk(ue @ ie.T, seen, k)
            ref = retrieval_ref64(ue, ie, seen)
            timing_inputs[timing_key] = (ue, ie, seen, k)
        else:
            A = cuda(interaction_matrix(g.n_users, g.n_items, g.train, g.val))
            W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
            want = fs.fused_lgcnhs_serve_ref(ue, ie, A, W, seen, k)[0]
            ref = serve_ref64(ue, ie, A, W, seen)
            if timing_key:  # the 49,410-item catalog's W (9.8 GB) is not kept
                timing_inputs[timing_key] = (ue, ie, A, W, seen, k)
        agreement, gap = tie_equivalence(torch, want, got, ref)
        check(f"{label} tie-equivalent to the plain chain",
              agreement >= AGREEMENT_MIN and gap <= GAP_MAX,
              f"agreement {agreement:.6f}, max relative gap {gap:.3e}")
        del ref, want
        torch.cuda.empty_cache()

    timing_keys = {("LightGCNOpti", "movielens1m", K_SLICE): "fused_topk_retrieval",
                   ("LightGCNOpti", "synthetic", K_SLICE): "fused_topk_big",
                   ("LightGCNOpti", "synthetic", K_LARGE): "fused_topk_k1000",
                   ("SpreadLightGCNOpti", "movielens1m", K_SLICE): "fused_lgcnhs_serve"}
    for (model, args, k), rec in zip(runs, outputs):
        cfg, g, params = cells[(model, args[1], k)]
        output_checks(model, args[1], cfg, g, params, rec, timing_keys.get((model, args[1], k)))

    def float64_checks():
        """Float64 checkpoints at ML-1M through cli/retrieve: served at f64 on
        the card by the plain chain, as the JAX package serves them, with no
        kernel launched. The ids are held against the same chain at f64 on
        the card (identical) and against it on the CPU, another device's f64
        products: identical for LightGCNOpti; for SpreadLightGCNOpti, whose F
        is an f32 product summed in another order there, tie-equivalent
        under the CPU's scores."""
        work64 = tempfile.mkdtemp(prefix="chip_smoke_f64_", dir=os.path.join(ROOT, "artifacts"))
        for model in ("LightGCNOpti", "SpreadLightGCNOpti"):
            cfg, g, params = make_cell(model, ml1m, K_SLICE, work64, torch.float64)
            before = {name: fn.launches for name, fn in kernels.items()}
            rec = retrieve.main(["--device", "cuda", "--workdir", work64, "--model", model,
                                 *ml1m])
            counted = {name: fn.launches - before[name] for name, fn in kernels.items()}
            seen_h = torch.from_numpy(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val))
            ue_h, ie_h = params.user_emb.cpu(), params.item_emb.cpu()
            seen, ue, ie = cuda(seen_h), ue_h.to(dev), ie_h.to(dev)
            if model == "LightGCNOpti":
                want = masked_topk(ue @ ie.T, seen, K_SLICE)
                host = masked_topk(ue_h @ ie_h.T, seen_h, K_SLICE)
                ref = None
            else:
                A_h = torch.from_numpy(interaction_matrix(g.n_users, g.n_items, g.train, g.val))
                A = cuda(A_h)
                W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
                want = fs.fused_lgcnhs_serve_ref(ue, ie, A, W, seen, K_SLICE)[0]
                W_h = W.cpu()
                fused = (ue_h @ ie_h.T) * (A_h @ W_h)
                ref = torch.where(seen_h, torch.full_like(fused, fs.EXCLUDED), fused)
                host = select_topk(ref, K_SLICE)[1]
            got = cuda(rec)
            label = f"cli/retrieve {model} movielens1m float64 checkpoint"
            check(f"{label}: served at f64 on the card by the plain chain, no kernel "
                  "launched, identical to that chain run directly",
                  ue.dtype == torch.float64 and torch.equal(got, want)
                  and not any(counted.values()),
                  f"{int((got != want).sum())} mismatches, launches {counted}")
            if ref is None:
                check(f"{label}: identical to the chain at f64 on the CPU",
                      torch.equal(got.cpu(), host), f"{int((got.cpu() != host).sum())} mismatches")
            else:
                agreement, gap = tie_equivalence(torch, host, got.cpu(), ref)
                check(f"{label}: tie-equivalent to the chain on the CPU",
                      agreement >= AGREEMENT_MIN and gap <= GAP_MAX,
                      f"agreement {agreement:.6f}, max relative gap {gap:.3e}")
            del want, host, ref
        shutil.rmtree(work64, ignore_errors=True)

    check.guard("float64 checkpoints", float64_checks)
    torch.cuda.empty_cache()

    # the training slice: an empty workdir, so cli/retrieve trains first
    print(f"[phase 4] cli/retrieve trains LightGCNOpti ({TRAIN_EPOCHS} epochs) and serves",
          flush=True)
    train_work = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(ROOT, "artifacts"))
    path_kernels = {**kernels, "dual_matmul": prop.dual_matmul}
    for fn in path_kernels.values():
        fn.launches = 0
    prop.dual_matmul.reduce_launches = 0
    t0 = time.perf_counter()
    rec = retrieve.main(["--device", "cuda", "--workdir", train_work, "--model",
                         "SpreadLightGCNOpti", *ml1m, "--epochs", str(TRAIN_EPOCHS)])
    torch.cuda.synchronize()
    train_serve_s = time.perf_counter() - t0
    train_launches = {name: fn.launches for name, fn in path_kernels.items()}
    reduce_launches = prop.dual_matmul.reduce_launches
    print(f"[phase 4] train + serve in {train_serve_s:.2f} s; launches {train_launches}, "
          f"dual_matmul split-K sum {reduce_launches}", flush=True)
    check(f"training path launched dual_matmul 6 x {TRAIN_EPOCHS}",
          train_launches["dual_matmul"] == 6 * TRAIN_EPOCHS, f"{train_launches['dual_matmul']}")
    check("training path launched dual_matmul's split-K sum with each call",
          reduce_launches == train_launches["dual_matmul"], f"{reduce_launches}")
    check("training path launched fused_lgcnhs_serve", train_launches["fused_lgcnhs_serve"] > 0)
    cfg_t = tcfg.load_config(env="prod", dataset="movielens1m", model="SpreadLightGCNOpti",
                             workdir=train_work, overrides={"hparams.epochs": TRAIN_EPOCHS})
    with open(os.path.join(cfg_t.pictures_path, f"LightGCNOpti_{cfg_t.k}_val_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    history = {name: [float(r[name]) for r in rows] for name in rows[0]}
    print(f"[phase 4] history {json.dumps(history)}", flush=True)
    check("training history: every value finite",
          all(math.isfinite(v) for col in history.values() for v in col))
    iters = [int(v) for v in history["iters"]]
    check(f"training history: evals at {list(range(0, TRAIN_EPOCHS, 200))}",
          iters == list(range(0, TRAIN_EPOCHS, 200)), f"{iters}")
    tl = dict(zip(iters, history["train_loss"]))
    check("training: train loss at epoch 800 below epoch 0", tl.get(800, 0.0) < tl.get(0, 0.0),
          f"{tl.get(0)} -> {tl.get(800)}")
    params_t = load_checkpoint(checkpoint_path(cfg_t), dev)
    output_checks("SpreadLightGCNOpti", "movielens1m (trained)", cfg_t, graph, params_t, rec,
                  "fused_lgcnhs_serve")

    def twin_route_compare():
        """TWIN_EPOCHS epochs from one seed on the kernel route and on the
        same route with the plain twin in the kernel's place."""
        cfg20 = tcfg.load_config(env="prod", dataset="movielens1m", model="LightGCNOpti",
                                 workdir=train_work,
                                 overrides={"hparams.epochs": TWIN_EPOCHS,
                                            "hparams.epoch_per_eval": 10})
        results, counts = {}, {}
        for route in ("kernel", "twin"):
            kernel_fn = prop.dual_matmul
            if route == "twin":
                prop.dual_matmul = prop.dual_matmul_ref
            kernel_fn.launches = 0
            try:
                results[route] = trainer.train_lightgcn(graph, cfg20, feats_u, feats_i,
                                                        save_artifacts=False, device=dev)
            finally:
                prop.dual_matmul = kernel_fn
            counts[route] = kernel_fn.launches
        check("twin route: kernel launched 6 a step, twin route none",
              counts == {"kernel": 6 * TWIN_EPOCHS, "twin": 0}, f"{counts}")
        hk, ht = results["kernel"].history, results["twin"].history
        loss_gap = max(abs(a - b) for col in ("train_loss", "val_loss")
                       for a, b in zip(hk[col], ht[col]))
        table_gap = max((a - b).abs().max().item() for a, b in
                        zip(results["kernel"].params, results["twin"].params))
        scale = max(t.abs().max().item() for t in results["twin"].params)
        print(f"[phase 4] kernel vs twin route, {TWIN_EPOCHS} epochs: losses "
              f"{hk['train_loss']} / {ht['train_loss']}, max loss gap {loss_gap:.3e}, "
              f"max table gap {table_gap:.3e} (table scale {scale:.3e})", flush=True)
        check(f"kernel route tracks the twin route over {TWIN_EPOCHS} epochs: losses",
              loss_gap <= TWIN_LOSS_TOL, f"max gap {loss_gap:.3e}, tolerance {TWIN_LOSS_TOL:g}")
        check(f"kernel route tracks the twin route over {TWIN_EPOCHS} epochs: tables",
              table_gap <= TWIN_TABLE_TOL,
              f"max gap {table_gap:.3e}, tolerance {TWIN_TABLE_TOL:g}")

    check.guard("kernel route against the twin route", twin_route_compare)
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(train_work, ignore_errors=True)

    # -- 5. timings at the main path's shapes ------------------------------
    print(f"[phase 5] timings on {smi}", flush=True)
    report = []
    sources = {
        "fused_topk_retrieval": ("lgcnhs_tpu_torch/ops/cuda/retrieval.cu",
                                 "lgcnhs_tpu/ops/pallas/retrieval.py:110"),
        "fused_lgcnhs_serve": ("lgcnhs_tpu_torch/ops/cuda/fusion_serve.cu",
                               "lgcnhs_tpu/ops/pallas/fusion_serve.py:120"),
    }

    def device_ms_by_kernel(fn, n):
        """{kernel name: device ms per call of fn} from torch.profiler over
        n calls, and the window's wall ms; ({}, None) when it traces no
        device time."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / n
        except Exception:  # no device trace: reported as not measured
            traceback.print_exc()
            return {}, None
        by_kernel = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
                by_kernel[ev.key] = dev_us / 1e3 / n
        return by_kernel, wall_ms

    for name, fn in kernels.items():
        inputs = timing_inputs[name]
        twin = fs.fused_lgcnhs_serve_ref if name == "fused_lgcnhs_serve" \
            else rt.fused_topk_retrieval_ref
        got, want = fn(*inputs), twin(*inputs)
        max_abs_err = (got[1] - want[1]).abs().max().item()
        reps = 10
        ms = median_ms(torch, lambda: fn(*inputs), reps)
        plain_ms = median_ms(torch, lambda: twin(*inputs), reps)
        if name == "fused_lgcnhs_serve":
            ue, ie, A, W, seen, k = inputs
            U, D = ue.shape
            I = ie.shape[0]

            def composition():
                fused = torch.matmul(ue, ie.T) * torch.matmul(A, W)
                return torch.topk(fused.masked_fill_(seen, fs.EXCLUDED), k, dim=1)

            nnz = int((A != 0).sum())
            nbytes = 4 * (U * D + I * D + U * I + I * I) + U * I + 8 * U * k
            flops = 2 * nnz * I + 2 * U * I * D + U * I
            # the design's own floor: its dense F (three bf16 parts of W)
            dense_floor_ms = 3 * 2 * U * I * I / PEAK_BF16_FLOP_PER_S * 1e3
        else:
            ue, ie, seen, k = inputs
            U, D = ue.shape
            I = ie.shape[0]

            def composition():
                return torch.topk(torch.matmul(ue, ie.T).masked_fill_(seen, MASK_VALUE), k, dim=1)

            nbytes = 4 * (U * D + I * D) + U * I + 8 * U * k
            flops = 2 * U * I * D
        # no single PyTorch call computes either function (library_ms is
        # null); the nearest library composition is timed beside it
        composition_ms = median_ms(torch, composition, reps)
        bound_ms, bound_by = bound(nbytes, flops)
        src, replaces = sources[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches[name], "max_abs_err": max_abs_err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "matmul_topk_ms": composition_ms}
        own = {"fused_topk_retrieval": ("fused_topk_kernel", "part_lists_merge"),
               "fused_lgcnhs_serve": ("fused_serve_kernel", "part_lists_merge", "bf16_parts")}

        def own_device_ms(call):
            """(device ms of one call's own kernels, {kernel: ms})."""
            by_kernel, _ = device_ms_by_kernel(call, 5)
            return (sum(v for n_, v in by_kernel.items() if any(o in n_ for o in own[name]))
                    or None), by_kernel

        dev_ms, by_kernel = own_device_ms(lambda: fn(*inputs))
        comp_kernels, _ = device_ms_by_kernel(composition, 5)
        comp_dev = sum(comp_kernels.values()) or None
        row.update(device_ms=dev_ms, matmul_topk_device_ms=comp_dev,
                   bound_share=bound_ms / dev_ms if dev_ms else None,
                   merge_launches=merges[name])
        extra = (f", device {dev_ms} ms ({row['bound_share']} of the bound; matmul+topk "
                 f"device {comp_dev}), kernels {by_kernel}; {merges[name]} merge launches")
        if name == "fused_lgcnhs_serve":
            row.update(split_launches=serve_splits)
            extra += f", {serve_splits} split launches; dense floor {dense_floor_ms} ms"
        else:
            # the same kernel takes the place of the streaming Pallas kernel:
            # timed over the 49,410-item catalog at k=100 and at k=1000 too
            row["also_replaces"] = "lgcnhs_tpu/ops/pallas/retrieval.py:265"
            for key in ("fused_topk_big", "fused_topk_k1000"):
                big_in = timing_inputs[key]
                tag = f"catalog_{big_in[1].shape[0]}_k{big_in[3]}"
                big_ms = median_ms(torch, lambda: fn(*big_in), reps)
                big_dev = own_device_ms(lambda: fn(*big_in))[0]
                row.update({f"{tag}_ms": big_ms, f"{tag}_device_ms": big_dev})
                extra += f"; {tag} {big_ms:.4f} ms (device {big_dev})"
        print(f"[phase 5] {name} U={U} I={I} D={D} k={k}: {ms:.4f} ms (twin {plain_ms:.4f}, "
              f"matmul+topk {composition_ms:.4f}, bound {bound_ms:.4f} by {bound_by}) "
              f"max_abs_err {max_abs_err:.3e}{extra} [{smi}]", flush=True)
        report.append(row)

    # dual_matmul at the training step's shapes: the slice's int8 incidence
    # (padded once per run, as the trainer does) and the bf16 layer-0
    # operands of the trained tables
    U, I, D = graph.n_users, graph.n_items, 64
    X = (di_slice[:, None] * params_t.item_emb).to(torch.bfloat16)
    Y = (du_slice[:, None] * params_t.user_emb).to(torch.bfloat16)
    R8p = prop.pad_for_dual(R8_slice)
    got = prop.dual_matmul(R8p, X, Y)
    want = prop.dual_matmul_ref(R8_slice, X, Y)
    max_abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    reps = 20
    ms = median_ms(torch, lambda: prop.dual_matmul(R8p, X, Y), reps)
    pad_ms = median_ms(torch, lambda: prop.pad_for_dual(R8_slice), reps)
    Xg, Yg = X.detach().requires_grad_(True), Y.detach().requires_grad_(True)
    out = prop.dual_matmul(R8p, Xg, Yg)
    cot = (torch.randn_like(out[0]), torch.randn_like(out[1]))
    bwd_ms = median_ms(torch, lambda: torch.autograd.grad(out, (Xg, Yg), cot, retain_graph=True),
                       reps)
    plain_ms = median_ms(torch, lambda: prop.dual_matmul_ref(R8_slice, X, Y), reps)
    Rb = R8_slice.to(torch.bfloat16)
    matmul_ms = median_ms(torch, lambda: (torch.matmul(Rb, X), torch.matmul(Rb.T, Y)), reps)
    matmul_dev, _ = device_ms_by_kernel(lambda: (torch.matmul(Rb, X), torch.matmul(Rb.T, Y)),
                                        20)
    del Rb
    dual_dev, _ = device_ms_by_kernel(lambda: prop.dual_matmul(R8p, X, Y), 20)
    dual_device_ms = sum(dual_dev.values()) if dual_dev else None
    matmul_device_ms = sum(matmul_dev.values()) if matmul_dev else None
    nnz = int(R8_slice.sum(dtype=torch.int64))
    deg_u = R8_slice.sum(dim=1, dtype=torch.int64)
    deg_i = R8_slice.sum(dim=0, dtype=torch.int64)
    skew = (f"degrees: users max {int(deg_u.max())}, items max {int(deg_i.max())}, "
            f"items p99 {float(deg_i.double().quantile(0.99)):.1f}")
    # each input read once (R int8, X and Y bf16), each output written once (f32)
    nbytes = U * I + 2 * (I * D + U * D) + 4 * (U * D + I * D)
    bound_ms, bound_by = bound(nbytes, 4 * nnz * D, PEAK_BF16_FLOP_PER_S)
    share = f"{bound_ms / dual_device_ms:.3f}" if dual_device_ms else "not measured"
    report.append({
        "name": "dual_matmul", "route": "cuda",
        "source": "lgcnhs_tpu_torch/ops/cuda/propagation.cu",
        "replaces": "lgcnhs_tpu/ops/pallas/propagation.py:164",
        "launches": train_launches["dual_matmul"], "reduce_launches": reduce_launches,
        "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "matmul_ms": matmul_ms, "matmul_device_ms": matmul_device_ms,
        "backward_ms": bwd_ms, "device_ms": dual_device_ms, "pad_ms": pad_ms,
        "bound_share": bound_ms / dual_device_ms if dual_device_ms else None,
    })
    dual_row = report[-1]
    print(f"[phase 5] dual_matmul U={U} I={I} D={D} nnz={nnz} int8/bf16: forward {ms:.4f} ms "
          f"(device {dual_device_ms}, {share} of the bound), backward {bwd_ms:.4f} ms, "
          f"row padding {pad_ms:.4f} ms once per run, twin {plain_ms:.4f}, two bf16 matmuls "
          f"{matmul_ms:.4f} (device {matmul_device_ms}), bound {bound_ms:.4f} by {bound_by}, "
          f"max_abs_err {max_abs_err:.3e}; {skew}; device ms by kernel {dual_dev} [{smi}]",
          flush=True)

    # the train step over a synchronized steady window, then its device
    # time by kernel
    hp = cfg_t.hparams
    p0 = init_lightgcn_opti(torch.Generator().manual_seed(SEED), feats_u, feats_i, D, dev)
    p0 = LightGCNParams(*(t.clone().requires_grad_(True) for t in p0))
    step = trainer.make_train_step(trainer.make_optimizer(hp, p0), hp, I,
                                   bf16_matmul=True, use_kernel=True)
    te = unique_edges(graph.train)
    step_args = ((R8p, du_slice, di_slice),
                 torch.from_numpy(te.users.astype(np.int64)).to(dev),
                 torch.from_numpy(te.items.astype(np.int64)).to(dev),
                 cuda(pos_bool_matrix(U, I, graph.train)))
    epoch = [0]

    def one_step():
        e = epoch[0]
        epoch[0] += 1
        return step(p0, e, trainer.epoch_generator(hp.seed, e, dev), *step_args)

    for _ in range(20):
        one_step()
    torch.cuda.synchronize()
    n_steps = 200
    t0 = time.perf_counter()
    for _ in range(n_steps):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    step_dev, step_wall = device_ms_by_kernel(one_step, 20)
    busy_ms = sum(step_dev.values())
    dual_step_ms = sum(v for k, v in step_dev.items() if "dual_" in k)
    top = sorted(step_dev.items(), key=lambda kv: -kv[1])[:8]
    idle = f"{1 - busy_ms / step_wall:.3f}" if step_dev and step_wall else "not measured"
    dual_row.update(step_ms=step_ms, step_device_busy_ms=busy_ms, step_idle_share=idle,
                    step_dual_device_ms=dual_step_ms)
    print(f"[phase 5] train step (int8 dual_matmul route, B={hp.batch_size}): {step_ms:.4f} ms, "
          f"{hp.batch_size / step_ms * 1e3:.1f} examples/s over {n_steps} steps; profiled "
          f"window {step_wall} ms/step, device busy {busy_ms:.4f} ms/step "
          f"(idle share {idle}), dual_matmul kernels {dual_step_ms:.4f} ms/step; top kernels "
          f"{json.dumps([(k[:60], round(v, 5)) for k, v in top])} [{smi}]", flush=True)

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    if check.failures:
        print(f"chip_smoke: {len(check.failures)} FAILED: {check.failures}", flush=True)
        return 1
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The f32 accumulation of ``dual_matmul`` against the sum length, on one card.

    python3 tools/dual_accum.py DIR [DIR ...]

Each DIR holds a ``propagation.cu`` (with the ``common.cuh`` it includes)
and the package's launcher; pass ``lgcnhs_tpu_torch/ops/cuda`` for the
current source. Every variant is built with the package's nvcc flags and
launched on bf16-exact operands (every product exact in f32) with a dense
int8 R of ones, so each output sums L products, of mixed signs (N(0, 1))
or all positive (|N(0, 1)|: the partial sums grow as L):

- role U: out_u = R @ X with R (128, L);
- role I: out_i = R^T @ Y with R (L, 128);

for L = 3,706 (ML-1M's items), 10,000, 30,000 and 100,000, at D=64. Each
line gives the max |kernel - exact| / max |exact| (exact: the f64 sums),
the mean signed error over the same scale (a sum that truncates each add
leans one way; one that rounds to nearest does not) and the plain twin's
(an f32 ``torch.matmul``, TF32 off) gap on the same inputs. Then each
variant's ms at ML-1M (int8 R of the seeded stand-in, bf16 X and Y), in
A..Z, Z..A rounds, three times: median CUDA-event ms of one launch.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

import torch  # noqa: E402

from lgcnhs_tpu_torch.ops.cuda import propagation as prop  # noqa: E402

LENGTHS = (3706, 10_000, 30_000, 100_000)
WIDE = 128  # the other side of R
D = 64
P, INT = ctypes.c_void_p, ctypes.c_int


def launcher(lib, dev):
    """launch(R padded int8, X bf16 (I, D), Y bf16 (U, D)) -> (out_u, out_i)
    with the package wrapper's split rule for this variant."""
    fn = lib.dual_matmul_launch
    fn.argtypes = [INT, INT, P, INT, P, P] + [INT] * 6 + [P] * 4
    fn.restype = INT
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def launch(R, X, Y):
        U, I = R.shape
        slots = n_sms * lib.dual_matmul_resident_blocks(2, 1, D)
        su, si = prop.dual_splits(U, I, lib.dual_matmul_block_rows(2, 1, D), slots)
        n_ws = ((su if su > 1 else 0) * U + (si if si > 1 else 0) * I) * D
        ws = torch.empty(max(n_ws, 1), dtype=torch.float32, device=dev)
        out_u = torch.empty((U, D), dtype=torch.float32, device=dev)
        out_i = torch.empty((I, D), dtype=torch.float32, device=dev)
        rc = fn(2, 1, R.data_ptr(), R.stride(0), X.data_ptr(), Y.data_ptr(), D, U, I, D, su, si,
                ws.data_ptr() if n_ws else None, out_u.data_ptr(), out_i.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"dual_matmul_launch: CUDA error {rc}")
        return out_u, out_i

    return launch


def gap(got, exact):
    scale = exact.abs().max().item()
    err = got.double() - exact
    return err.abs().max().item() / scale, err.mean().item() / scale


def main(dirs) -> int:
    from kernel_ab import compile_variant, events_ms, slice_inputs
    from lgcnhs_tpu_torch.train.trainer import device_binary_factors

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    launches = {d: launcher(compile_variant(n, d)["propagation"], dev) for n, d in enumerate(dirs)}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for L, role, signs in itertools.product(LENGTHS, ("U", "I"), ("mixed", "positive")):
        shape = (WIDE, L) if role == "U" else (L, WIDE)
        R = torch.ones(shape, dtype=torch.int8, device=dev)
        Rp = prop.pad_for_dual(R)
        X, Y = (torch.randn((n, D), generator=gen, device=dev) for n in (shape[1], shape[0]))
        if signs == "positive":  # partial sums grow as L, not as sqrt(L)
            X, Y = X.abs(), Y.abs()
        X, Y = X.to(torch.bfloat16), Y.to(torch.bfloat16)
        exact = (R.double() @ X.double()) if role == "U" else (R.double().T @ Y.double())
        twin = prop.dual_matmul_ref(R, X, Y)[0 if role == "U" else 1]
        row = {"role": role, "L": L, "signs": signs, "twin": gap(twin, exact)}
        for d, launch in launches.items():
            row[d] = gap(launch(Rp, X, Y)[0 if role == "U" else 1], exact)
        rows.append(row)
        print(f"[accum] role {role} L={L} {signs}: " + ", ".join(
            f"{k} max {v[0]:.3e} mean {v[1]:+.3e}" for k, v in row.items()
            if k not in ("role", "L", "signs")) + f" [{smi}]", flush=True)
        del R, Rp, X, Y, exact
    g, ue, ie, _ = slice_inputs(dev, "movielens1m", {})
    R8 = prop.pad_for_dual(device_binary_factors(g.n_users, g.n_items, g.train, dev)[0])
    X, Y = ie.to(torch.bfloat16), ue.to(torch.bfloat16)
    times = {d: [] for d in dirs}
    for _ in range(3):
        for d in list(dirs) + list(reversed(dirs)):
            times[d].append(events_ms(lambda: launches[d](R8, X, Y), reps=10))
    for d, ts in times.items():
        ts = sorted(ts)
        print(f"[accum] {d} ML-1M {tuple(R8.shape)} int8/bf16 D={D}: median {ts[len(ts) // 2]:.4f} "
              f"ms (all {[round(t, 4) for t in ts]}) [{smi}]", flush=True)
    print(json.dumps({"card": smi, "gaps": rows,
                      "ms": {d: sorted(ts)[len(ts) // 2] for d, ts in times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

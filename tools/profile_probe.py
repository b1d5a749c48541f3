#!/usr/bin/env python3
"""Does ``torch.profiler`` keep the card's records late in a long process?

One process, nothing else run in it: the retrieval kernel is built, then
``--sessions`` profiler sessions follow each other, ``--gap`` seconds apart
(the card kept busy with matmuls in between, or idle with ``--idle``).
Each session waits ``pad`` ms on the host, launches a few matmuls (torch's
kernels) and one ``fused_topk_retrieval`` (the ctypes kernel), synchronizes
and waits ``pad`` ms again; ``pad`` alternates between 0 and ``--pad`` ms,
so a skew between the card's and the host's clocks of up to ``--pad`` ms
keeps the kernels inside the window.

    python3 tools/profile_probe.py [--sessions 10] [--gap 45] [--pad 200] [--idle]
                                   [--first-after SECONDS]

Prints one JSON line a session: the process's age, the pad, the kernels
launched since the previous session, the launch calls and the kernel
events kept (every session launches the same kernels) and their names,
whether the retrieval kernel was kept, the skew, each kept kernel's start
minus its launch call's start (matched by CUPTI correlation id; under a
few milliseconds when the two agree), and the shift, each launch call's
start minus its host operator's (CUPTI's clock against the profiler's
host clock; between 0 and the operator's length when they agree). The
card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MATMULS = 4


def trace_skews(path):
    """(kernel names, skews, shifts, launch calls) of a chrome trace. A skew
    (ms) is a kernel event's start minus the start of the runtime or driver
    call that launched it (both CUPTI's); a shift (ms) is a launch call's
    start minus the start of the host operator it ran in (the host clock
    of the profiler), which lies between 0 and that operator's length when
    the two clocks agree; launch calls are the runtime or driver launch
    events kept."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launch_ts, op_ts, calls = {}, {}, []
    for e in events:
        args = e.get("args", {})
        if e.get("cat") == "cpu_op" and "External id" in args:
            op_ts[args["External id"]] = e["ts"]
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch_ts[args["correlation"]] = e["ts"]
            if "Launch" in e.get("name", ""):
                calls.append(e)
    names, skews, shifts = [], [], []
    for e in events:
        if e.get("cat") == "kernel":
            names.append(e["name"])
            launched = launch_ts.get(e.get("args", {}).get("correlation"))
            if launched is not None:
                skews.append((e["ts"] - launched) / 1e3)
    for e in calls:
        op = op_ts.get(e["args"].get("External id"))
        if op is not None:
            shifts.append((e["ts"] - op) / 1e3)
    return names, skews, shifts, len(calls)


def spread(values):
    """[min, median, max] of values, or None."""
    return [min(values), statistics.median(values), max(values)] if values else None


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sessions", type=int, default=10)
    p.add_argument("--gap", type=float, default=45.0, help="seconds between sessions")
    p.add_argument("--pad", type=float, default=200.0, help="ms of host wait, odd sessions")
    p.add_argument("--idle", action="store_true", help="leave the card idle between sessions")
    p.add_argument("--first-after", type=float, default=0.0,
                   help="seconds the process waits, idle, before its first session")
    args = p.parse_args()
    t_start = time.perf_counter()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_probe: no CUDA card", file=sys.stderr)
        return 2
    from lgcnhs_tpu_torch.ops.cuda import retrieval as rt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[profile_probe] {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    # cli/main's retrieval at ML-1M: 6040 users, 3706 items, width 64, top-100
    ue = torch.randn(6040, 64, device="cuda", generator=g)
    ie = torch.randn(3706, 64, device="cuda", generator=g)
    seen = torch.rand(6040, 3706, device="cuda", generator=g) < 0.05
    a = torch.randn(2048, 2048, device="cuda", generator=g)
    rt.fused_topk_retrieval(ue, ie, seen, 100)  # builds and loads the kernel
    torch.cuda.synchronize()

    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    out = tempfile.mkdtemp(prefix="profile_probe_", dir=os.path.join(ROOT, "artifacts"))
    time.sleep(args.first_after)
    for i in range(args.sessions):
        between = 0  # kernels launched since the last session
        if i:
            t_next = time.perf_counter() + args.gap
            while time.perf_counter() < t_next:
                if args.idle:
                    time.sleep(min(0.5, args.gap))
                else:
                    for _ in range(20):
                        a = torch.tanh(a @ a)
                    between += 40
                    torch.cuda.synchronize()
        pad = args.pad if i % 2 else 0.0
        age = time.perf_counter() - t_start
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(pad / 1e3)
            for _ in range(MATMULS):
                a = torch.tanh(a @ a)
            rt.fused_topk_retrieval(ue, ie, seen, 100)
            torch.cuda.synchronize()
            time.sleep(pad / 1e3)
        path = os.path.join(out, f"session{i}.json")
        prof.export_chrome_trace(path)
        names, skews, shifts, calls = trace_skews(path)
        print(json.dumps({
            "session": i, "age_s": age, "pad_ms": pad, "launched_between": between,
            "launch_calls_kept": calls, "kernels_kept": len(names),
            "retrieval_kept": any("fused_topk_kernel" in n for n in names),
            "kept": [n[:24] for n in names], "skew_ms": spread(skews),
            "shift_ms": spread(shifts),
        }), flush=True)
    print(f"[profile_probe] {args.sessions} sessions, {'idle' if args.idle else 'busy'} gaps "
          f"of {args.gap} s, {time.perf_counter() - t_start:.1f} s [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

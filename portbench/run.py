"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up (data from the seed, the program's own set-up and warm-up) is
timed as ``setup_s``; then the driver measures for ``--seconds``; then the
reference checks what the window produced. With ``--trace 1`` one profiler
session covers the window's first ``trace_seconds`` (the cell's traffic
file), where a traced run's window ends, and the line carries the cell's
per-layer metrics instead of its end-to-end ones. The last line of
standard output is the result; the checks, each number beside its limit,
are the last lines of standard error. Exits non-zero, printing no result,
without CUDA or with fewer cards than the cell asks for, or when a module
of JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from portbench import env  # noqa: E402

env.prepare()


def _plain(x):
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    bench = harness.benchmark_spec()
    chips = harness.cell_entry(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"cuda available {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    from portbench.gpu import gpu_name_and_power

    card = gpu_name_and_power()
    print(f"portbench: {args.workload} seed {args.seed} on {card}", file=sys.stderr, flush=True)
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START, bench)
    found = harness.loaded_forbidden()
    if found:
        print(f"portbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr, flush=True)
        return 3
    print(json.dumps(_plain(line)), flush=True)
    for name, c in line["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

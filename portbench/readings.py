"""The readings the check's limits are set from; not part of a run.

    python3 portbench/readings.py --workload <name> --seeds <n> [<n> ...] [--seconds <s>]
                                  [--controls <m>]

For each seed, in one process, at the cell's own size: the program's
numbers (a run of the cell's driver with a window of ``--seconds``,
checked as a run checks it), the control's (the reference in the
precision below the configured one, put in the program's place) and, for
training cells, the faults': half of each batch (the mean over the rest),
the learning rate left undecayed. A training cell's control and faults
start from the seed and, for each judged interval, from the program's own
state at its first boundary, as the reference does. One JSON line a seed;
a summary line last with each number's largest program reading and
smallest control and fault readings. ``--controls m`` reads the control
and the faults on the first m seeds only (the program on all).
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from portbench import env  # noqa: E402

env.prepare()

FAULTS = {"half_batch": {"half_batch": True}, "lr_undecayed": {"lr_decay": False}}


def readings(cell: str, seed: int, device: str, seconds: float = 11.0, bench=None,
             workload=None, config=None, controls: bool = True) -> dict:
    import torch

    from portbench import harness, judge, problem
    from portbench.reference import serve as ref_serve

    bench = harness.benchmark_spec() if bench is None else bench
    entry = harness.cell_entry(bench, cell)
    workload = harness.workload_file(cell) if workload is None else workload
    config = harness.config_file(entry["config"]) if config is None else config
    driver = __import__(f"portbench.drivers.{workload['driver']}", fromlist=["run"])
    dev = torch.device(device)
    train = workload["driver"] == "train"
    window = harness.Window(seconds if train else 0.0, dev, {})
    t0 = time.perf_counter()
    outcome = driver.run(config, workload["traffic"], seed, window, dev)
    run_s = time.perf_counter() - t0
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "run_s": run_s, "window_s": window.elapsed}
    if train:
        ref = driver.Reference(outcome, dev)
        start, spans = ref.readouts()
        out["program"] = judge.train_numbers(outcome.readout, start, spans)
        out["judged"] = {"starts": len(outcome.starts),
                         "spans": [[s.epoch0, s.n] for s in outcome.spans]}
        cases = {"control": {"precision": "fp8"}, **FAULTS} if controls else {}
        for name, kw in cases.items():
            c_start, c_spans = ref.readouts(**kw)
            out[name] = judge.train_numbers(judge.TrainReadout([c_start], c_spans), start, spans)
    else:
        out["program"], _ = driver.check(outcome, dev)
        split = problem.reference_split(outcome.config, outcome.rows)
        ref = driver.reference_scores(outcome, split)
        low = driver.reference_scores(outcome, split, "bfloat16")
        out["control"] = {"score_gap": judge.score_gap(ref_serve.top_lists(low, config["k"]), ref)}
    out["check_s"] = time.perf_counter() - t0 - run_s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seconds", type=float, default=11.0,
                    help="a training cell's window (one job's return and the next start)")
    ap.add_argument("--controls", type=int, default=None,
                    help="read the control and faults on the first this many seeds only")
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    args = ap.parse_args(argv)
    rows = []
    for j, seed in enumerate(args.seeds):
        row = readings(args.workload, seed, args.device, args.seconds,
                       controls=args.controls is None or j < args.controls)
        rows.append(row)
        text = json.dumps(row)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    summary = {"workload": args.workload, "seeds": len(rows)}
    for kind, pick in (("program", max), ("control", min), *((f, min) for f in FAULTS)):
        if kind in rows[0]:
            summary[kind] = {k: pick(r[kind][k] for r in rows if kind in r)
                             for k in rows[0][kind]}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

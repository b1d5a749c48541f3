"""Tiny copies of the cells for CPU tests: the cell's own files with the
synthetic scale, the job length (600 epochs: a training window from epoch
400 holds a job's return and the next job's start) and k cut down, and
float32 compute: on the CPU the bfloat16 preset takes a plain dense bf16
route whose gaps at 60 x 150 are those of a few dozen summands, not the
card's."""
import copy

from portbench import harness

SIZES = {"users": 60, "items": 150, "draws": 3000}


def cell(name: str, **sizes):
    bench = harness.benchmark_spec()
    entry = harness.cell_entry(bench, name)
    workload = copy.deepcopy(harness.workload_file(name))
    config = copy.deepcopy(harness.config_file(entry["config"]))
    config["synthetic"].update({**SIZES, **sizes})
    config["epochs"] = 600
    config["k"] = 10
    config["dtype"] = "float32"
    if "judged_among" in workload["traffic"]:  # a tiny window holds a few intervals
        workload["traffic"]["judged_among"] = 4
    return bench, workload, config


def run(name: str, seed: int = 2**31 + 11, seconds: float = 1.5, trace: bool = False, **sizes):
    bench, workload, config = cell(name, **sizes)
    return harness.run_cell(name, seed, seconds, trace, "cpu", bench=bench,
                            workload=workload, config=config)

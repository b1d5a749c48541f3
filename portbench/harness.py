"""One run of one cell: set-up, the measured window, the trace, the check.

Everything is found by name. ``BENCHMARK.json`` names the cell and its
metrics; ``workloads/<cell>.json`` names the cell's configuration, its
driver and its traffic and holds the limits of its check;
``configs/<config>.json`` holds the configuration as it is run;
``drivers/<driver>.py`` sets the program up, drives the window and checks
what it produced against ``reference/``; ``metrics/<metric>.py`` reads one
per-layer metric from the trace. A new cell, configuration or metric is
new files only.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Optional

from portbench import judge
from portbench import trace as tracing

PACKAGE = Path(__file__).resolve().parent
REPO = PACKAGE.parent
#: Top-level module names that no run may load (compared whole: the port's
#: own name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "lgcnhs_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec() -> dict:
    return read_json(REPO / "BENCHMARK.json")


def workload_file(name: str) -> dict:
    return read_json(PACKAGE / "workloads" / f"{name}.json")


def config_file(name: str) -> dict:
    return read_json(PACKAGE / "configs" / f"{name}.json")


def peaks() -> dict:
    return read_json(PACKAGE / "peaks.json")


def load_metric(name: str):
    """The reader module ``metrics/<name>.py``."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_entry(bench: dict, cell: str) -> dict:
    for entry in bench["workloads"]:
        if entry["name"] == cell:
            return entry
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def end_to_end_of(bench: dict, cell: str) -> list:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_of(bench: dict, cell: str) -> list:
    moved = {m["name"] for m in end_to_end_of(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in moved else [])]


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def _read_counter(path: str):
    module, _, attr = path.partition(":")
    value = importlib.import_module(module)
    for part in attr.split("."):
        value = getattr(value, part)
    return value


class Window:
    """The measured window: opened and closed by the driver, on a device
    with nothing queued. Holds the host times (``perf_counter`` and the wall
    clock in ns, the trace's base) and the counters' readings. A traced
    run's window is its traced part: the profiler session starts as the
    window opens, and the window ends at the driver's first boundary after
    ``trace_seconds`` (or ``seconds``, if less), the trace with it."""

    def __init__(self, seconds: float, device, counters: Dict[str, str],
                 trace_seconds: Optional[float] = None):
        self.seconds = seconds
        self.device = device
        self.counters = counters
        self.traced = trace_seconds is not None
        self.trace_seconds = trace_seconds
        self.session = None
        self.t_open = self.t_close = None
        self.ns_open = self.ns_close = None
        self._at_open: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}

    def _sync(self):
        if self.device.type == "cuda":
            import torch

            torch.cuda.synchronize(self.device)

    def open(self) -> None:
        """Opens the window; the memory peak is the window's from here."""
        self._sync()
        if self.device.type == "cuda":
            import torch

            torch.cuda.reset_peak_memory_stats(self.device)
        self._at_open = {k: _read_counter(p) for k, p in self.counters.items()}
        if self.traced:
            self.session = tracing.Session(self.device.type == "cuda")
        self.t_open, self.ns_open = time.perf_counter(), time.time_ns()

    def expired(self) -> bool:
        """Whether the window is over at this boundary of the driver's (the
        card idle): once ``seconds`` have passed, or a traced run's trace
        has been stopped here or before."""
        now = time.perf_counter()
        if self.traced:
            if self.session.result is None \
                    and now >= self.t_open + min(self.trace_seconds, self.seconds):
                self._stop_trace()
            return self.session.result is not None
        return now >= self.t_open + self.seconds

    def _stop_trace(self) -> None:
        self._sync()
        self.counts = {k: _read_counter(p) - self._at_open[k] for k, p in self.counters.items()}
        self.session.stop()

    def close(self) -> None:
        self._sync()
        self.t_close, self.ns_close = time.perf_counter(), time.time_ns()
        if self.session is not None and self.session.result is None:
            self._stop_trace()

    @property
    def elapsed(self) -> float:
        return self.t_close - self.t_open


@dataclass
class Context:
    """What a per-layer reader gets: the trace of the window, the driver's
    records of it, the problem's shapes, the peaks and the counters."""

    view: tracing.TraceView
    records: dict
    shapes: dict
    peaks: dict
    counts: dict


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, bench: Optional[dict] = None,
             workload: Optional[dict] = None, config: Optional[dict] = None) -> dict:
    """The result line of one run (a dict, ``checks`` last), or raises."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    bench = benchmark_spec() if bench is None else bench
    entry = cell_entry(bench, cell)
    workload = workload_file(cell) if workload is None else workload
    if workload["config"] != entry["config"]:
        raise ValueError(f"workloads/{cell}.json names config {workload['config']!r}, "
                         f"BENCHMARK.json {entry['config']!r}")
    config = config_file(entry["config"]) if config is None else config
    driver = importlib.import_module(f"portbench.drivers.{workload['driver']}")
    dev = torch.device(device)

    layer_specs = per_layer_of(bench, cell) if trace else []
    readers = {m["name"]: load_metric(m["name"]) for m in layer_specs}
    counters: Dict[str, str] = {}
    for r in readers.values():
        counters.update(getattr(r, "COUNTERS", {}))
    window = Window(seconds, dev, counters,
                    workload["traffic"]["trace_seconds"] if trace else None)
    try:
        outcome = driver.run(config, workload["traffic"], seed, window, dev)
    finally:
        if window.session is not None:
            window.session.stop()
    peak_bytes = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    t_done = time.perf_counter()
    view = None
    if window.session is not None:
        view = tracing.collect(window.session, (window.ns_open, window.session.stopped_ns))
        window.session = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_read = time.perf_counter()
    numbers, shapes = driver.check(outcome, dev)
    print(f"portbench: set-up {window.t_open - t_start:.3f} s, window {window.elapsed:.3f} s, "
          f"trace read {t_read - t_done:.3f} s ({len(view.device_ops) if view else 0} device "
          f"ops), check {time.perf_counter() - t_read:.3f} s", file=sys.stderr, flush=True)
    limits = workload["limits"]
    correct = judge.verdict(numbers, limits) and outcome.failed == 0

    line = {"correct": bool(correct), "attempted": outcome.attempted, "failed": outcome.failed}
    metrics = {}
    if not trace:
        known = dict(outcome.e2e)
        known["setup_s"] = window.t_open - t_start
        for m in end_to_end_of(bench, cell):
            if m["name"] == "peak_mem_gib":  # the window's peak
                known[m["name"]] = peak_bytes / 2**30
            if m["name"] not in known:
                raise KeyError(f"driver {workload['driver']!r} gives no {m['name']!r}")
            metrics[m["name"]] = {"value": known[m["name"]], "unit": m["unit"]}
    else:
        ctx = Context(view, outcome.records, shapes, peaks(), window.counts)
        for m in layer_specs:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line["metrics"] = metrics
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": entry["chips"], "memory_peak_bytes": int(peak_bytes)}
    if view is not None:
        device_info["busy_s"] = view.busy_s()
        device_info["window_s"] = view.window_s
        line["breakdown"] = {"device_ops": view.top_device_ops(), "idle_gaps": view.idle_gaps()}
    line["device"] = device_info
    line["checks"] = {name: {"value": numbers.get(name, math.nan), "limit": limit}
                      for name, limit in limits.items()}
    return line

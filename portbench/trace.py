"""The reduction from a ``torch.profiler`` session to what the per-layer
metrics read.

One session a traced run, the process's only one: it starts as the window
opens (inside the process's first minute: a session started later loses
card records) and stops at the window's first boundary (the end of a
pass, an evaluation record) at or after the cell's ``trace_seconds``
(``workloads/<cell>.json``) or ``--seconds``, whichever is less; a traced
run's window ends there. Set-up is not traced: the profiler slows the
host work it records (a CUDA graph's capture most), which would read as
idle card. Everything here is clipped to the traced window. Times are
nanoseconds on the host's wall clock, the base the profiler aligns the
card's records to.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

COPY_PREFIXES = ("Memcpy", "Memset")


@dataclass
class TraceView:
    """The device's operations and the host's ranges of one traced window."""

    window: Tuple[int, int]
    device_ops: List[Tuple[str, int, int]] = field(default_factory=list)
    host_ops: List[Tuple[str, int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def within(self, records, end=lambda r: r[1]) -> list:
        """The driver's records that end inside the traced window."""
        return [r for r in records if end(r) <= self.window[1]]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's operations, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device_ops
                       if e > lo and s < hi)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_percent(self):
        """The share of the window with nothing on the card, or None
        without a device operation to read."""
        if not self.device_ops:
            return None
        return 100.0 * (1.0 - self.busy_s() / self.window_s)

    def kernels_named(self, *fragments: str) -> List[Tuple[str, int, int]]:
        """The window's device operations whose names hold a fragment."""
        lo, hi = self.window
        return [op for op in self.device_ops
                if op[1] >= lo and op[2] <= hi and any(f in op[0] for f in fragments)]

    def first_kernel_after(self, t: int, until: int):
        """Start of the first device kernel (no copy) in [t, until), or None."""
        starts = [s for name, s, _ in self.device_ops
                  if t <= s < until and not name.startswith(COPY_PREFIXES)]
        return min(starts) if starts else None

    def top_device_ops(self, n: int = 10) -> List[list]:
        lo, hi = self.window
        total: Dict[str, int] = {}
        for name, s, e in self.device_ops:
            if e > lo and s < hi:
                total[name] = total.get(name, 0) + min(e, hi) - max(s, lo)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The longest spans of the window with nothing on the device, each
        named by the innermost host range open at its middle."""
        lo, hi = self.window
        edges = [lo]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(hi)
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        if self.host_ops:
            starts = np.fromiter((s for _, s, _ in self.host_ops), np.int64, len(self.host_ops))
            ends = np.fromiter((e for _, _, e in self.host_ops), np.int64, len(self.host_ops))
        out = []
        for length, start in gaps:
            mid = start + length // 2
            label = "host outside any recorded range"
            if self.host_ops:
                inside = np.flatnonzero((starts <= mid) & (ends >= mid))
                if inside.size:
                    best = inside[np.argmin(ends[inside] - starts[inside])]
                    label = self.host_ops[best][0]
            out.append([label[:120], length / 1e9])
        return out


class Session:
    """One profiler session: the host's ranges, and the card's operations
    with ``cuda``. Stopped without the profiler's own parsing of its
    events, which at millions of kernels takes minutes."""

    def __init__(self, cuda: bool):
        from torch.autograd import profiler

        self._profile = profiler.profile(use_kineto=True, use_device="cuda" if cuda else None)
        self._profile.__enter__()
        self.result = None
        self.stopped_ns = None

    def stop(self) -> None:
        if self.result is None:
            import time

            import torch

            self.stopped_ns = time.time_ns()
            self.result = torch.autograd._disable_profiler()


def collect(session: Session, window: Tuple[int, int]) -> TraceView:
    """The session's events that touch the window."""
    lo, hi = window
    view = TraceView(window)
    for ev in session.result.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if end < lo or start > hi:
            continue
        if str(ev.device_type()).endswith("CUDA"):
            if not ev.is_user_annotation():  # a host range drawn on the card's row
                view.device_ops.append((ev.name(), start, end))
        else:
            view.host_ops.append((ev.name(), start, end))
    return view

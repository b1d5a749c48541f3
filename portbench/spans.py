"""What the program's spans tell of a traced window.

The port opens a named range around its host work where that work happens
(``lgcnhs_tpu_torch/runtime/logging.span``: the trainer's replays and
boundaries, ``serve_fused``'s build, upload, W, ranking and download).
Inside the benchmark's profiler session each is a host event of the
session under its own name, on the clock of the card's operations, so it
is in ``TraceView.host_ops``. A program without spans has none there, and
every reading here is then None.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

Interval = Tuple[int, int]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The sorted, merged union of ``intervals``."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def length(intervals: Iterable[Interval]) -> int:
    return sum(e - s for s, e in intervals)


def overlap(a: List[Interval], b: List[Interval]) -> int:
    """The time two merged, sorted lists of intervals share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def named(view, *names: str) -> List[Interval]:
    """The union of the host's ranges called ``names``, clipped to the window."""
    lo, hi = view.window
    return union((max(s, lo), min(e, hi)) for name, s, e in view.host_ops
                 if name in names and e > lo and s < hi)


def idle(view) -> List[Interval]:
    """The window's time with nothing on the card."""
    lo, hi = view.window
    edges = [lo]
    for s, e in view.busy_intervals():
        edges += [s, e]
    edges.append(hi)
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_share_inside(view, *names: str) -> Optional[float]:
    """The share of the window, in %, in which nothing runs on the card
    while the host is inside a span called one of ``names``; None without
    a device operation or such a span."""
    spans = named(view, *names)
    if not view.device_ops or not spans:
        return None
    return 100.0 * overlap(idle(view), spans) / (view.window[1] - view.window[0])


def share_of_outer(view, outer: str, inner: str) -> Optional[float]:
    """Over the ``outer`` spans that end in the window: the time inside
    ``inner`` spans within them over the time inside them, in %; None
    without such a span."""
    lo, hi = view.window
    outers = union((s, e) for name, s, e in view.host_ops
                   if name == outer and s >= lo and e <= hi)
    total = length(outers)
    if not total:
        return None
    inners = union((s, e) for name, s, e in view.host_ops if name == inner)
    return 100.0 * overlap(outers, inners) / total

"""Counters of the program, inside and outside CUDA graphs.

Each counter is an attribute of the function it counts for: the kernel
wrappers' launches (``dual_matmul.launches``, ``dual_matmul.reduce_launches``,
``fused_lgcnhs_serve.launches``), ``serve_fused``'s passes and the bytes it
hands the card (``models/fusion``). ``count(fn, attr, n)`` adds to one. A
count made while a CUDA graph captures the current stream stands for work
that runs only when the graph is replayed, so under ``capture_tally()`` it
is noted in the tally instead, and ``add_replays(tally)`` adds the graph's
counts at each replay (``train/trainer.TrainScan``). Outside a tally a
count is added when it is made.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Iterator, List

import torch

_TALLIES: List[Counter] = []


def count(fn, attr: str, n: int = 1) -> None:
    """``fn.<attr>`` += n, or, while a graph captures the current stream
    inside ``capture_tally``, n in its tally."""
    if _TALLIES and torch.cuda.is_current_stream_capturing():
        _TALLIES[-1][(fn, attr)] += n
    else:
        setattr(fn, attr, getattr(fn, attr) + n)


def count_launch(fn, attr: str = "launches") -> None:
    """One launch of ``fn``'s kernel (``count``)."""
    count(fn, attr)


@contextlib.contextmanager
def capture_tally() -> Iterator[Counter]:
    """The counts made while the block captures, as {(fn, attr): n}."""
    tally: Counter = Counter()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.pop()


def add_replays(tally: Counter, replays: int = 1) -> None:
    """Adds ``replays`` replays of a graph whose capture noted ``tally``."""
    for (fn, attr), n in tally.items():
        setattr(fn, attr, getattr(fn, attr) + n * replays)

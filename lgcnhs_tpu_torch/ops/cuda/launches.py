"""Launch counts of the kernel wrappers, inside and outside CUDA graphs.

Each wrapper counts the launches of its kernel in attributes of its own
(``dual_matmul.launches``, ``dual_matmul.reduce_launches``). A launch made
while a CUDA graph captures the current stream runs only when the graph is
replayed, so under ``capture_tally()`` it is noted in the tally instead, and
``add_replays(tally)`` adds the graph's launches to the counts at each
replay (``train/trainer.TrainScan``). Outside a tally a launch counts when
it is made.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from typing import Iterator, List

import torch

_TALLIES: List[Counter] = []


def count_launch(fn, attr: str = "launches") -> None:
    """One launch of ``fn``'s kernel: ``fn.<attr>`` += 1, or, while a graph
    captures the current stream inside ``capture_tally``, one in its tally."""
    if _TALLIES and torch.cuda.is_current_stream_capturing():
        _TALLIES[-1][(fn, attr)] += 1
    else:
        setattr(fn, attr, getattr(fn, attr) + 1)


@contextlib.contextmanager
def capture_tally() -> Iterator[Counter]:
    """The launches captured inside the block, as {(fn, attr): n}."""
    tally: Counter = Counter()
    _TALLIES.append(tally)
    try:
        yield tally
    finally:
        _TALLIES.pop()


def add_replays(tally: Counter, replays: int = 1) -> None:
    """Counts ``replays`` replays of a graph whose capture noted ``tally``."""
    for (fn, attr), n in tally.items():
        setattr(fn, attr, getattr(fn, attr) + n * replays)

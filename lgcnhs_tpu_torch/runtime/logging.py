"""Logging, stage timing, spans and profiling.

Port of ``lgcnhs_tpu/runtime/logging.py``: the console DEBUG + timestamped
file INFO handlers and the ``@calTimes``-style wall-clock timer of the
reference's ``utils/log.py`` / ``utils/wrapper.py``, and ``profile_trace``,
which records a ``torch.profiler`` trace where JAX records a
``jax.profiler`` one.

``span(name)`` names a range of the program's host work (the
trainer's replays and boundaries, ``serve_fused``'s build, upload, W,
ranking and download): while a profiler session records (``profile_trace``,
``cli/main --profile``, or any other) it is a ``record_function`` range of
that session, on the clock the session gives the card's operations, so the
spans appear in ``--profile`` traces beside the kernels they launch; with
no session it costs one check. ``stage_timer`` takes a span name too.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from datetime import datetime
from typing import Callable, Iterator, Optional

import torch

from lgcnhs_tpu_torch.runtime.mesh import is_writer, rank

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
_configured: dict = {}


def get_logger(name: str = "lgcnhs", file_dir: Optional[str] = None) -> logging.Logger:
    """Console DEBUG + optional timestamped INFO file handler, matching the
    reference handler setup (``utils/log.py:30-53``). Under a process group
    only rank 0 writes the file."""
    logger = logging.getLogger(name)
    if name in _configured:
        return logger
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    console = logging.StreamHandler()
    console.setLevel(logging.DEBUG)
    console.setFormatter(logging.Formatter(_FORMAT))
    logger.addHandler(console)

    if file_dir and is_writer():
        os.makedirs(file_dir, exist_ok=True)
        stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
        fh = logging.FileHandler(os.path.join(file_dir, f"{stamp}.log"))
        fh.setLevel(logging.INFO)
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)

    _configured[name] = True
    return logger


class span:
    """``with span(name):`` a named range of the body while a profiler
    session records, nested ranges under the range open around them. With
    no session it does nothing beyond that one check: no synchronisation,
    no device work."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name, self._range = name, None

    def __enter__(self) -> "span":
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None


@contextlib.contextmanager
def stage_timer(msg: str, logger: Optional[logging.Logger] = None,
                span_name: Optional[str] = None) -> Iterator[None]:
    """Context-manager counterpart of the reference's ``@calTimes``
    decorator; with ``span_name`` the stage is also a ``span``."""
    log = logger or get_logger()
    start = time.perf_counter()
    with span(span_name) if span_name else contextlib.nullcontext():
        yield
    log.info("%s, elapsed: %.2f s", msg, time.perf_counter() - start)


def timed(msg: str, logger: Optional[logging.Logger] = None) -> Callable:
    """Decorator flavor, drop-in for reference ``calTimes(logger, msg)``."""

    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with stage_timer(msg, logger):
                return fn(*args, **kwargs)

        return wrapper

    return deco


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str], device: torch.device | str) -> Iterator[None]:
    """Optional ``torch.profiler`` trace of the body (the JAX package's
    ``jax.profiler`` trace; no reference counterpart): a no-op for ``None``
    or ``""``. Records the host's activity, and the card's when ``device`` is
    CUDA, and writes a TensorBoard-readable ``rank<r>.<ns>.pt.trace.json``
    into ``log_dir`` (``tensorboard_trace_handler``) on the way out: one file
    a rank under a process group. The program's spans (``span``) are ranges
    of the trace."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    handler = tensorboard_trace_handler(log_dir, worker_name=f"rank{rank()}")
    with profile(activities=activities, on_trace_ready=handler):
        yield

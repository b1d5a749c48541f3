"""Logging + stage timing.

Port of ``lgcnhs_tpu/runtime/logging.py``: the console DEBUG + timestamped
file INFO handlers and the ``@calTimes``-style wall-clock timer of the
reference's ``utils/log.py`` / ``utils/wrapper.py``. The JAX profiler context
has no counterpart here.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from datetime import datetime
from typing import Callable, Iterator, Optional

from lgcnhs_tpu_torch.runtime.mesh import is_writer

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


@contextlib.contextmanager
def stage_timer(msg: str, logger: Optional[logging.Logger] = None) -> Iterator[None]:
    """Context-manager counterpart of the reference's ``@calTimes`` decorator."""
    log = logger or get_logger()
    start = time.perf_counter()
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

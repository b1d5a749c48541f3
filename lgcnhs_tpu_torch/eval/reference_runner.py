"""Loader for the UPSTREAM reference's own modules, for differential runs.

Port of ``lgcnhs_tpu/eval/reference_runner.py``, used by
``cli/parity_report.py`` (the ``BASELINE.md`` section-6 protocol: run the
reference pipeline next to ours and diff the metric tables). The reference
modules import a module-global config (``const.cfg``, which makedirs on
import) and a file logger; both are replaced with inert stubs, so importing
has no side effects and never writes into the read-only reference tree.
This module LOADS reference code at run time; it contains none of it.

The reference checkout is looked for at ``~/reference``, the home directory
of the user running the port (the JAX package fixes it at the root user's).
"""
from __future__ import annotations

import importlib
import sys
import types
from pathlib import Path
from types import SimpleNamespace

REF_ROOT = Path.home() / "reference"


def reference_available() -> bool:
    return REF_ROOT.exists()


class _NullLogger:
    def __getattr__(self, _name):
        return lambda *a, **k: None


class ReferenceModules:
    """Context manager loading the reference's SpreadMethod model/recommend,
    trans converters, and both metric files with side-effect stand-ins for
    its const/logging globals. Yields a namespace with the loaded modules
    plus the mutable fake ``cfg`` (set DATA_SET / MODEL / RECOMMEND before
    calling into the reference). ``sys.modules`` is restored on exit."""

    _STUBBED = (
        "const", "utils", "utils.log", "utils.wrapper", "model", "metrics",
        "model.SpreadMethod", "model.SpreadMethod.model",
        "model.SpreadMethod.recommend", "metrics.accurate",
        "metrics.diversity", "utils.trans",
    )

    def __init__(self, save_dir: str, ref_root: Path = REF_ROOT, k: int = 10):
        self.ref_root = ref_root
        self.save_dir = save_dir
        self.k = k

    def __enter__(self) -> SimpleNamespace:
        self._saved = {n: sys.modules.get(n) for n in self._STUBBED}
        cfg = SimpleNamespace(
            DATA_SET="douban",  # callers override per run
            MODEL={"name": "HybridS", "HyperParameter": {"lambda": 0.5}},
            RECOMMEND={"save_path": self.save_dir + "/", "k": self.k},
        )
        utils_pkg = types.ModuleType("utils")
        utils_pkg.__path__ = [str(self.ref_root / "utils")]
        log_stub = types.ModuleType("utils.log")
        log_stub.logger = _NullLogger()
        wrapper_stub = types.ModuleType("utils.wrapper")
        wrapper_stub.calTimes = lambda _l, _m: (lambda fn: fn)
        const_stub = types.ModuleType("const")
        const_stub.cfg = cfg
        model_pkg = types.ModuleType("model")
        model_pkg.__path__ = [str(self.ref_root / "model")]
        metrics_pkg = types.ModuleType("metrics")
        metrics_pkg.__path__ = [str(self.ref_root / "metrics")]
        sys.modules.update(
            {
                "utils": utils_pkg,
                "utils.log": log_stub,
                "utils.wrapper": wrapper_stub,
                "const": const_stub,
                "model": model_pkg,
                "metrics": metrics_pkg,
            }
        )
        return SimpleNamespace(
            cfg=cfg,
            spread=importlib.import_module("model.SpreadMethod.model"),
            spread_rec=importlib.import_module("model.SpreadMethod.recommend"),
            accurate=importlib.import_module("metrics.accurate"),
            diversity=importlib.import_module("metrics.diversity"),
            trans=importlib.import_module("utils.trans"),
        )

    def __exit__(self, *exc):
        for n, m in self._saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m
        return False

"""``lgcnhs_tpu_torch/entry.py`` against ``__graft_entry__``.

- ``entry(device="cpu")`` builds JAX's inputs: the tables bitwise, A and
  seen elementwise, λ a float32 scalar; its forward gives (64, 10) int32 ids
  identical to ``jax.jit`` of JAX's ``entry()`` forward on the CPU.
- ``entry()`` without CUDA raises, naming ``device="cpu"``.
- ``python -m lgcnhs_tpu_torch.entry --device cpu`` prints JAX's
  ``entry OK: (64, 10)``.
- The module imports neither JAX nor the JAX package, and the package walk
  of ``tests/test_torch_main.py::test_no_port_module_imports_jax`` reaches
  it; ``dryrun_multichip`` is ``parallel/dryrun.py``'s.
"""
import os
import pkgutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import lgcnhs_tpu_torch
from lgcnhs_tpu_torch import entry as tentry
from lgcnhs_tpu_torch.parallel import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def both():
    """(JAX's (fn, args), the port's (fn, args) on the CPU)."""
    return jentry.entry(), tentry.entry(device="cpu")


def test_toy_problem_is_jax_copy():
    for got, want in zip(tentry._toy_problem(), jentry._toy_problem()):
        np.testing.assert_array_equal(got, want)


def test_entry_inputs_equal_jax(both):
    (_, (jparams, jA, jseen, jlam)), (_, (params, A, seen, lam)) = both
    for got, want in zip(params, jparams):
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    assert A.dtype == torch.float32 and seen.dtype == torch.bool
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_array_equal(seen.numpy(), np.asarray(jseen))
    assert lam.dtype == torch.float32 and lam.dim() == 0
    assert lam.item() == float(jlam)


def test_entry_ids_identical_to_jax(both):
    (jfn, jargs), (fn, args) = both
    want = np.asarray(jax.jit(jfn)(*jargs))
    got = fn(*args)
    assert got.dtype == torch.int32 and tuple(got.shape) == (64, 10) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_entry_without_cuda_names_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.entry()


def test_entry_main_prints_shape():
    proc = subprocess.run([sys.executable, "-m", "lgcnhs_tpu_torch.entry", "--device", "cpu"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.splitlines()[-1] == "entry OK: (64, 10)"


def test_entry_imports_no_jax_and_is_walked():
    names = {m.name for m in pkgutil.walk_packages(lgcnhs_tpu_torch.__path__,
                                                   "lgcnhs_tpu_torch.")}
    assert "lgcnhs_tpu_torch.entry" in names
    assert tentry.dryrun_multichip is dryrun.dryrun_multichip
    code = ("import sys, lgcnhs_tpu_torch.entry; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'lgcnhs_tpu', '__graft_entry__')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr

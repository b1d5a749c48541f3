"""Builds and loads the package's CUDA sources.

Each ``<name>.cu`` beside this file (with the shared ``*.cuh`` headers) is
compiled at first use by ``nvcc`` into a shared library with a plain C
interface, which ``ctypes`` loads; the wrappers pass ``tensor.data_ptr()``
and the current stream's handle. This is the package's one build route: it
needs no ninja and no PyTorch headers, so a source builds in seconds.

Libraries go into ``_build/`` beside the sources (ignored by git), named by
a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "_build"
SOURCES = ("retrieval", "fusion_serve", "propagation", "segment_propagation")
NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or str(Path(cuda_home) / "bin" / "nvcc")
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, Path]:
    """Compiles every named source whose library is missing, all ``nvcc``
    processes at once, and returns {name: library path}. ``verbose`` adds
    ``-Xptxas -v`` and prints what the compiler reports (registers, shared
    memory, spills). Raises with the compiler's output if any build fails."""
    paths = {name: library_path(name) for name in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{output}")
            continue
        if verbose and output:
            print(f"[nvcc {name}.cu]\n{output}", flush=True)
        os.replace(tmp, todo[name])  # atomic: concurrent builds race safely
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        lib.lgcnhs_max_smem_optin.argtypes = [ctypes.c_int]
        lib.lgcnhs_max_smem_optin.restype = ctypes.c_int
        lib.lgcnhs_error_string.argtypes = [ctypes.c_int]
        lib.lgcnhs_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def device_smem_limit(name: str, device: torch.device) -> int:
    """Dynamic shared memory one block may opt in to on a CUDA ``device``
    (``cudaDevAttrMaxSharedMemoryPerBlockOptin``), read through library
    ``name``; the dispatch guards size every kernel against it."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    v = load_library(name).lgcnhs_max_smem_optin(index)
    if v <= 0:
        raise RuntimeError(f"cannot read the shared-memory limit of cuda:{index}")
    return v


def check_launch(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raises when a launcher returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if code != 0:
        msg = lib.lgcnhs_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")

"""The process environment of a benchmark process, set before torch loads:
every build and kernel cache at a fixed path inside the checkout (the
port's own kernels build into its package: ``ops/cuda/_build``,
``native/_build``), and no library allowed to load JAX by itself."""
import os
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / ".portbench_cache"


def prepare() -> None:
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))

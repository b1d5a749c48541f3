"""Stage-level artifact cache.

Port of ``lgcnhs_tpu/runtime/cache.py``: the reference's
try-load-else-recompute of stage artifacts (``main.py:28-46,61-80``;
``model/LightGCN/recommend.py:148-154``) as a keyed cache of .npz, .npy
and .json payloads. The formats are the JAX package's, so either package
reads the other's cached lists.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict, Optional

import numpy as np


class ArtifactCache:
    def __init__(self, root: str, enabled: bool = True) -> None:
        self.root = root
        self.enabled = enabled
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str, ext: str) -> str:
        return os.path.join(self.root, f"{key}.{ext}")

    # ---- npz dict-of-arrays ----
    def load_or_compute_arrays(
        self, key: str, compute: Callable[[], Dict[str, np.ndarray]]
    ) -> Dict[str, np.ndarray]:
        path = self._path(key, "npz")
        if self.enabled and os.path.exists(path):
            with np.load(path, allow_pickle=False) as data:
                return {name: data[name] for name in data.files}
        result = compute()
        if self.enabled:
            np.savez(path, **result)
        return result

    # ---- recommendation lists: a dense (U, k) int array (the reference
    # pickles a defaultdict, model/SpreadMethod/recommend.py:54) ----
    def save_recommendations(self, key: str, rec: np.ndarray) -> str:
        path = self._path(key, "npy")
        np.save(path, rec)
        return path

    def load_recommendations(self, key: str) -> Optional[np.ndarray]:
        path = self._path(key, "npy")
        if self.enabled and os.path.exists(path):
            return np.load(path)
        return None

    # ---- small json blobs (metrics, configs) ----
    def save_json(self, key: str, payload: Dict[str, Any]) -> str:
        path = self._path(key, "json")
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=float)
        return path

    def load_json(self, key: str) -> Optional[Dict[str, Any]]:
        path = self._path(key, "json")
        if self.enabled and os.path.exists(path):
            with open(path) as f:
                return json.load(f)
        return None

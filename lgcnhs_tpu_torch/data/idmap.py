"""Internal/external id mapping.

Port of ``lgcnhs_tpu/data/idmap.py`` (a copy). The reference's abandoned ``Dataset`` container held uid/iid <-> index maps
(``waste/processing/dataset.py:16-``), and the live pipeline returns plain
mapping dicts from ``handleRating`` (``processing/handleData.py:70-77``).
This module packages both directions plus vectorized decoding of
recommendation matrices back to raw catalog ids — what a serving caller
actually needs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np


@dataclass(frozen=True)
class IdMapper:
    uid_to_internal: Dict
    iid_to_internal: Dict
    internal_to_uid: np.ndarray  # (U,) raw ids by internal index
    internal_to_iid: np.ndarray  # (I,) raw ids by internal index

    @classmethod
    def from_splits(cls, splits) -> "IdMapper":
        """From a ``RatingSplits`` (mappings produced by the sorted-unique
        remap in ``data/ratings.py``)."""
        u_map, i_map = splits.uid_mapping, splits.iid_mapping
        inv_u = np.empty(len(u_map), dtype=object)
        for raw, internal in u_map.items():
            inv_u[internal] = raw
        inv_i = np.empty(len(i_map), dtype=object)
        for raw, internal in i_map.items():
            inv_i[internal] = raw
        return cls(dict(u_map), dict(i_map), inv_u, inv_i)

    def users_to_internal(self, raw_ids: Sequence) -> np.ndarray:
        return np.asarray([self.uid_to_internal[r] for r in raw_ids], dtype=np.int32)

    def items_to_internal(self, raw_ids: Sequence) -> np.ndarray:
        return np.asarray([self.iid_to_internal[r] for r in raw_ids], dtype=np.int32)

    def decode_recommendations(self, rec: np.ndarray) -> Dict:
        """(U, k) internal-item-index matrix -> {raw user id: [raw item ids]}
        — the external-facing form of the reference's recommend dicts."""
        return {
            self.internal_to_uid[u]: [self.internal_to_iid[i] for i in rec[u]]
            for u in range(rec.shape[0])
        }

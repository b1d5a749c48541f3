"""Rating preprocessing pipeline, in numpy.

Port of ``lgcnhs_tpu/data/ratings.prepare_ratings`` (reference
``processing/handleData.py:17-123``), with the same split membership and row
order given the same input table and seed:

1. per-user rating-count quantile-band filter; ``np.quantile`` interpolates
   linearly like pandas' ``Series.quantile``
2. column projection + rename via ``columns_map``
3. dense 0..N-1 id remap in sorted-unique ("LabelEncoder") class order
4. 80/10/10 split by row. ``sklearn.train_test_split(x, test_size=t,
   random_state=s)`` is a ``RandomState(s).permutation(n)`` whose first
   ``ceil(t*n)`` entries are the test side and the rest the train side; the
   same is done here, and rows keep the permuted order ``.loc`` gives them.
5. with ``save_path``, the JAX package's artifacts, written without pandas
   (``runtime/table.py``) byte for byte as pandas writes them:
   ``filter_rating.csv``, ``train_data.csv``, ``val_data.csv``,
   ``test_data.csv`` and ``id_mappings.npz`` (the sorted raw classes).
   ``load_cached_splits`` reads them back.

String raw ids (Douban's ``USER_MD5``) remap in sorted order like ints,
as LabelEncoder orders them.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.synthetic import Columns
from lgcnhs_tpu_torch.runtime.logging import get_logger, stage_timer
from lgcnhs_tpu_torch.runtime.table import read_table, write_csv

COLUMNS = ("user_id", "item_id", "rating", "rating_time")


@dataclass
class RatingSplits:
    """The filtered table and its three splits, each a dict of the
    ``COLUMNS`` arrays."""

    rating: Columns
    train: Columns
    val: Columns
    test: Columns
    uid_mapping: Dict
    iid_mapping: Dict

    @property
    def n_users(self) -> int:
        return len(np.unique(self.rating["user_id"]))

    @property
    def n_items(self) -> int:
        return len(np.unique(self.rating["item_id"]))


def _dense_remap(values: np.ndarray) -> Tuple[np.ndarray, Dict]:
    """Sorted-unique to dense int remap (LabelEncoder class order)."""
    classes, codes = np.unique(values, return_inverse=True)
    return codes, dict(zip(classes.tolist(), range(len(classes))))


def _seeded_split(n: int, test_size: float, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(train positions, test positions) exactly as sklearn's shuffled
    ``train_test_split`` draws them."""
    perm = np.random.RandomState(seed).permutation(n)
    n_test = math.ceil(test_size * n)
    return perm[n_test:], perm[:n_test]


def _take(table: Columns, rows: np.ndarray) -> Columns:
    return {name: col[rows] for name, col in table.items()}


def prepare_ratings(rating: Columns, cfg: Config,
                    save_path: Optional[str] = None) -> RatingSplits:
    pre = cfg.preprocessing
    cols = pre.columns_map
    log = get_logger()

    with stage_timer("rating preprocessing done", log):
        # 1. quantile-band user-activity filter
        users = np.asarray(rating[cols["user_id"]])
        _, user_of_row, counts = np.unique(users, return_inverse=True, return_counts=True)
        thr_start = np.quantile(counts, pre.quantile_start)
        thr_end = np.quantile(counts, pre.quantile_end)
        log.info("quantile start %.4f threshold: %s", pre.quantile_start, thr_start)
        log.info("quantile end %.4f threshold: %s", pre.quantile_end, thr_end)
        # the rows of kept users, by each row's user (np.isin compares every
        # row with every kept id when the ids are strings)
        kept_user = (counts >= thr_end) & (counts <= thr_start)
        keep = np.flatnonzero(kept_user[user_of_row.ravel()])

        # 2. column projection + rename
        filtered = {
            new: np.asarray(rating[cols[old]])[keep]
            for new, old in zip(COLUMNS, ("user_id", "item_id", "rating", "rating_time"))
        }

        # 3. dense id remap
        filtered["user_id"], uid_mapping = _dense_remap(filtered["user_id"])
        filtered["item_id"], iid_mapping = _dense_remap(filtered["item_id"])

        # 4. seeded 8:1:1 row split
        train_idx, holdout_idx = _seeded_split(
            len(keep), pre.split_percentage[0], pre.seed
        )
        val_pos, test_pos = _seeded_split(
            len(holdout_idx), pre.split_percentage[1], pre.seed
        )
        train = _take(filtered, train_idx)
        val = _take(filtered, holdout_idx[val_pos])
        test = _take(filtered, holdout_idx[test_pos])

        for name, split in (("train", train), ("val", val), ("test", test)):
            log.info(
                "%s split: %d ratings, %d users, %d items",
                name,
                len(split["user_id"]),
                len(np.unique(split["user_id"])),
                len(np.unique(split["item_id"])),
            )

        # 5. artifacts
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            for name, table in (("filter_rating", filtered), ("train_data", train),
                                ("val_data", val), ("test_data", test)):
                write_csv(os.path.join(save_path, f"{name}.csv"), table)
            _save_id_mappings(save_path, uid_mapping, iid_mapping)

    return RatingSplits(filtered, train, val, test, uid_mapping, iid_mapping)


def _save_id_mappings(save_path: str, uid_mapping: Dict, iid_mapping: Dict) -> None:
    """The mappings are {raw_id -> dense_id} with dense ids 0..N-1 assigned in
    sorted-raw order, so the sorted raw-class arrays are a complete encoding."""
    np.savez(
        os.path.join(save_path, "id_mappings.npz"),
        uid_classes=np.asarray(list(uid_mapping.keys())),
        iid_classes=np.asarray(list(iid_mapping.keys())),
    )


def _load_id_mappings(save_path: str) -> Tuple[Dict, Dict]:
    path = os.path.join(save_path, "id_mappings.npz")
    if not os.path.exists(path):
        return {}, {}
    with np.load(path, allow_pickle=False) as data:
        uid = {k: i for i, k in enumerate(data["uid_classes"].tolist())}
        iid = {k: i for i, k in enumerate(data["iid_classes"].tolist())}
    return uid, iid


def load_cached_splits(save_path: str) -> Optional[RatingSplits]:
    """The CSV artifacts read back, with their id mappings, if all four exist
    (reference ``main.py:28-40``); columns typed as ``pd.read_csv`` types them."""
    paths = {
        name: os.path.join(save_path, f"{name}.csv")
        for name in ("filter_rating", "train_data", "val_data", "test_data")
    }
    if not all(os.path.exists(p) for p in paths.values()):
        return None
    uid_mapping, iid_mapping = _load_id_mappings(save_path)
    rating, train, val, test = (read_table(p) for p in paths.values())
    return RatingSplits(rating, train, val, test, uid_mapping, iid_mapping)

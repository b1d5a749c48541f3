"""MovieLens-100K ingestion + feature pipeline, without pandas.

Port of ``lgcnhs_tpu/data/movielens.py`` (reference
``processing/handleMovielens.py``). The four distribution files are read
by ``runtime/table.read_table`` as the JAX package's ``pd.read_csv`` calls
read them (``handleMovielens.py:122-172``):

- ``u.data``: user \\t item \\t rating \\t timestamp
- ``u.user``: user_id|age|gender|occupation|zip_code
- ``u.occupation``: one occupation per line
- ``u.item``: movie_id|title|release_date|video_release_date|IMDb_URL|19
  genre flags, latin-1; a field that opens with ``"`` is quoted

Features (``handleMovielens.py:20-104``):
- user = [gender binary, one-hot(age bucket), one-hot(occupation)]
- item = [19 genre flags, one-hot(release-year bucket), mean-pooled title
  embedding (dim 5, trained on ``device``)]; a missing release date (NaN,
  which pandas 3's ``astype(str)`` keeps) takes year bucket 0.

Output: dense float arrays aligned to INTERNAL ids (rows of filtered-out
entities are zero, rows of unknown raw ids dropped), plus the reference's
tab-separated list-valued feature CSVs (``handleMovielens.py:190-195``).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.features import age_bucket, one_hot, text_embeddings, year_bucket
from lgcnhs_tpu_torch.data.ratings import RatingSplits, prepare_ratings
from lgcnhs_tpu_torch.runtime.logging import get_logger, stage_timer
from lgcnhs_tpu_torch.runtime.table import Columns, as_str, read_table, write_csv

GENRE_COLUMNS = [
    "unknown", "Action", "Adventure", "Animation", "Children's", "Comedy",
    "Crime", "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror",
    "Musical", "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]
ITEM_COLUMNS = ["movie_id", "movie_title", "release_date", "video_release_date",
                "IMDb_URL"] + GENRE_COLUMNS

N_AGE_BUCKETS = 7  # ageMap values 1..7 (handleFeature.py:17-36)
N_YEAR_BUCKETS = 7  # yearMap values 0..6 (handleFeature.py:39-59)


def read_movielens_raw(paths: Dict[str, str]):
    rating = read_table(paths["rating"], sep="\t",
                        names=["user", "item", "rating", "timestamp"])
    users = read_table(paths["users"], sep="|",
                       names=["user_id", "age", "gender", "occupation", "zip_code"])
    occupations = read_table(paths["occupation"], sep="\t", names=["occupation"])
    items = read_table(paths["items"], sep="|", encoding="iso-8859-1", names=ITEM_COLUMNS)
    return rating, users, occupations, items


def movielens_user_features(users: Columns, occupations: Columns
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(raw user ids, feature rows): gender + one-hot(age) + one-hot(occ)
    (``handleMovielens.py:20-58``)."""
    occ_map = {name: idx for idx, name in enumerate(occupations["occupation"].tolist())}
    n_occ = len(occ_map)
    rows = []
    for gender, age, occupation in zip(users["gender"].tolist(), users["age"].tolist(),
                                       users["occupation"].tolist()):
        feats = [1 if gender == "M" else 0]
        feats += one_hot(age_bucket(int(age)), N_AGE_BUCKETS)
        feats += one_hot(occ_map.get(occupation, -1), n_occ)
        rows.append(feats)
    return users["user_id"], np.asarray(rows, dtype=np.float32)


def movielens_item_features(items: Columns, title_dim: int = 5, device="cuda"
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """(raw item ids, feature rows): 19 genre flags + one-hot(year bucket) +
    title embedding (``handleMovielens.py:62-104``)."""
    genres = np.stack([items[c] for c in GENRE_COLUMNS], axis=1).astype(np.float32)
    years = [year_bucket(int(d[-4:])) if isinstance(d, str) and d[-4:].isdigit() else 0
             for d in as_str(items["release_date"])]
    year_oh = np.asarray([one_hot(b, N_YEAR_BUCKETS) for b in years], dtype=np.float32)
    titles = text_embeddings(as_str(items["movie_title"]), title_dim, device=device)
    return items["movie_id"], np.concatenate([genres, year_oh, titles], axis=1)


def _remap_features(
    raw_ids: np.ndarray, feats: np.ndarray, mapping: Dict, n_rows: int
) -> np.ndarray:
    """Align raw-id feature rows to internal ids; unmatched -> dropped,
    missing internal rows -> zeros (``handleMovielens.py:182-187`` drops
    unmatched rows; zero-fill keeps the arrays dense)."""
    out = np.zeros((n_rows, feats.shape[1]), dtype=np.float32)
    for rid, row in zip(raw_ids.tolist(), feats):
        internal = mapping.get(rid)
        if internal is not None:
            out[internal] = row
    return out


def save_feature_csvs(
    save_path: str, user_feats: np.ndarray, item_feats: np.ndarray
) -> None:
    """Reference-format tab-separated list-valued CSVs
    (``handleMovielens.py:190-195``), as pandas writes them."""
    os.makedirs(save_path, exist_ok=True)
    for name, feats in (("user", user_feats), ("item", item_feats)):
        write_csv(os.path.join(save_path, f"{name}_features.csv"),
                  {f"{name}_id": np.arange(len(feats)),
                   f"{name}_features": [r.tolist() for r in feats]}, sep="\t")


def align_and_save(splits: RatingSplits, user: Tuple[np.ndarray, np.ndarray],
                   item: Tuple[np.ndarray, np.ndarray], save_path: Optional[str]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Both feature tables on internal ids, their CSVs written to ``save_path``."""
    user_features = _remap_features(*user, splits.uid_mapping, splits.n_users)
    item_features = _remap_features(*item, splits.iid_mapping, splits.n_items)
    if save_path:
        save_feature_csvs(save_path, user_features, item_features)
    return user_features, item_features


def prepare_movielens(
    cfg: Config, save_path: Optional[str] = None, device="cuda"
) -> Tuple[RatingSplits, np.ndarray, np.ndarray]:
    """Full MovieLens pipeline (``prepareMovieLens``,
    ``handleMovielens.py:108-204``)."""
    log = get_logger()
    with stage_timer("MovieLens dataset processing done", log):
        rating, users, occupations, items = read_movielens_raw(
            cfg.preprocessing.dataset_paths
        )
        splits = prepare_ratings(rating, cfg, save_path)
        user = movielens_user_features(users, occupations)
        item = movielens_item_features(items, cfg.preprocessing.vector_size["title"], device)
        user_features, item_features = align_and_save(splits, user, item, save_path)
    return splits, user_features, item_features

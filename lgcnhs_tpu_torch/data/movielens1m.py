"""MovieLens-1M ingestion + feature pipeline, without pandas.

Port of ``lgcnhs_tpu/data/movielens1m.py``, the 1M analog of
``data/movielens.py`` on the 1M distribution's ``::``-separated ``.dat``
files:

- ``ratings.dat``: UserID::MovieID::Rating::Timestamp, through the native
  parser (``native/bindings.parse_rating_rows``, one pass in C++) where it
  builds, else ``read_table``; either gives the same int64 columns
- ``users.dat``: UserID::Gender::Age::Occupation::Zip-code (7 age category
  codes, integer occupations 0..20)
- ``movies.dat``: MovieID::Title::Genres (latin-1; pipe-separated genres of
  an 18-genre vocabulary; the release year as the title's trailing "(YYYY)")

Features mirror the 100K analog: user = [gender, one-hot(ageMap bucket),
one-hot(occupation, 21)], item = [18 genre flags, one-hot(yearMap bucket of
the title year, 0 when absent), title embedding (dim 5)]. Rating
preprocessing is ``data/ratings.py``'s, shared with 100K.
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.features import (
    age_bucket, multi_hot, one_hot, text_embeddings, year_bucket,
)
from lgcnhs_tpu_torch.data.movielens import N_AGE_BUCKETS, N_YEAR_BUCKETS, align_and_save
from lgcnhs_tpu_torch.data.ratings import RatingSplits, prepare_ratings
from lgcnhs_tpu_torch.native import bindings as native
from lgcnhs_tpu_torch.runtime.logging import get_logger, stage_timer
from lgcnhs_tpu_torch.runtime.table import Columns, as_str, read_table

# The 1M genre vocabulary (README of the ml-1m distribution): ML-100K's 19
# per-column flags minus the "unknown" placeholder column.
GENRES_1M = [
    "Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
    "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
    "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western",
]

N_OCCUPATIONS_1M = 21  # integer codes 0..20 (users.dat README)
RATING_COLUMNS = ["user", "item", "rating", "timestamp"]

_YEAR_RE = re.compile(r"\((\d{4})\)\s*$")


def read_ratings_dat(path: str) -> Columns:
    """ratings.dat as int64 (user, item, rating, timestamp) columns."""
    parsed = native.parse_rating_rows(path, "::")
    if parsed is not None:
        return {name: col.astype(np.int64) for name, col in zip(RATING_COLUMNS, parsed)}
    return read_table(path, sep="::", names=RATING_COLUMNS)


def read_movielens1m_raw(paths: Dict[str, str]):
    """The three ``::``-separated .dat files (movies.dat is latin-1)."""
    rating = read_ratings_dat(paths["rating"])
    users = read_table(paths["users"], sep="::",
                       names=["user_id", "gender", "age", "occupation", "zip_code"])
    movies = read_table(paths["items"], sep="::", encoding="iso-8859-1",
                        names=["movie_id", "movie_title", "genres"])
    return rating, users, movies


def title_year(title: str) -> int:
    """yearMap bucket for the trailing "(YYYY)" of a 1M title; the sentinel
    bucket 0 when absent (the 100K missing-release-date analog)."""
    m = _YEAR_RE.search(title)
    return year_bucket(int(m.group(1))) if m else 0


def ml1m_user_features(users: Columns) -> Tuple[np.ndarray, np.ndarray]:
    """(raw user ids, feature rows): gender + one-hot(ageMap) +
    one-hot(occupation code) (``handleMovielens.py:20-58`` on 1M's codes)."""
    gender = np.asarray([g == "M" for g in as_str(users["gender"])], np.float32)[:, None]
    age_oh = np.asarray([one_hot(age_bucket(int(a)), N_AGE_BUCKETS)
                         for a in users["age"].tolist()], dtype=np.float32)
    # one_hot yields an all-zero vector for out-of-range codes
    occ_oh = np.asarray([one_hot(int(o), N_OCCUPATIONS_1M)
                         for o in users["occupation"].tolist()], dtype=np.float32)
    return users["user_id"], np.concatenate([gender, age_oh, occ_oh], axis=1)


def ml1m_item_features(movies: Columns, title_dim: int = 5, device="cuda"
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """(raw item ids, feature rows): 18 genre flags + one-hot(year bucket) +
    title embedding (``handleMovielens.py:62-104``, genres from the pipes)."""
    genres = multi_hot([str(g).split("|") for g in movies["genres"].tolist()], GENRES_1M)
    titles = as_str(movies["movie_title"])
    year_oh = np.asarray([one_hot(title_year(t), N_YEAR_BUCKETS) for t in titles],
                         dtype=np.float32)
    title_emb = text_embeddings(titles, title_dim, device=device)
    return movies["movie_id"], np.concatenate([genres, year_oh, title_emb], axis=1)


def prepare_movielens1m(
    cfg: Config, save_path: Optional[str] = None, device="cuda"
) -> Tuple[RatingSplits, np.ndarray, np.ndarray]:
    """Full MovieLens-1M pipeline, the ``prepareMovieLens`` analog
    (``handleMovielens.py:108-204``)."""
    log = get_logger()
    with stage_timer("MovieLens-1M dataset processing done", log):
        rating, users, movies = read_movielens1m_raw(cfg.preprocessing.dataset_paths)
        splits = prepare_ratings(rating, cfg, save_path)
        user = ml1m_user_features(users)
        item = ml1m_item_features(movies, cfg.preprocessing.vector_size["title"], device)
        user_features, item_features = align_and_save(splits, user, item, save_path)
    return splits, user_features, item_features

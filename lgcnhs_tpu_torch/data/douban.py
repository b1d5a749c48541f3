"""Douban movies ingestion + feature pipeline, without pandas.

Port of ``lgcnhs_tpu/data/douban.py`` (reference
``processing/handleDouban.py``). Schema: ``users.csv`` (USER_MD5,
USER_NICKNAME), ``movies.csv`` (MOVIE_ID, NAME, GENRES, LANGUAGES, REGIONS,
MINS, YEAR, STORYLINE, ...), ``ratings.csv`` (USER_MD5, MOVIE_ID, RATING,
RATING_TIME), each read by ``runtime/table.read_table`` as ``pd.read_csv``
reads it (quoted storylines with commas and line breaks included).

Pipeline (``handleDouban.py:160-215``):
- drop ratings whose movie is unknown, rows in order (``:182-183``)
- rating filter/split via the shared pipeline (the douban quantile band
  [0.991, 0.99] keeps the users whose rating counts lie between those
  quantiles of the counts, const.py:236-239)
- user features = 3-d text embedding of the nickname (``:29-56``)
- item features = concat [name emb(3), genres multi-hot, languages
  multi-hot, duration one-hot, storyline emb(20), regions multi-hot, year
  one-hot] (``:60-157``); the multi-hot vocabularies are sorted unions of
  the labels seen (``''`` of an empty GENRES cell included), MINS is coerced
  to numbers and its zeros and NaN mean-imputed before bucketing, YEAR is
  coerced with NaN as 0 (year bucket 1).
"""
from __future__ import annotations

import math
import re
from typing import List, Optional, Tuple

import numpy as np

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.features import (
    clean_genres,
    duration_bucket,
    language_codes,
    multi_hot,
    one_hot,
    region_codes,
    text_embeddings,
    year_bucket,
)
from lgcnhs_tpu_torch.data.movielens import align_and_save
from lgcnhs_tpu_torch.data.ratings import RatingSplits, prepare_ratings
from lgcnhs_tpu_torch.runtime.logging import get_logger, stage_timer
from lgcnhs_tpu_torch.runtime.table import Columns, as_str, read_table

N_DURATION_BUCKETS = 6  # durationMap values 1..6 (handleFeature.py:147-164)
# yearMap emits 0..6, but the Douban path fillna(0)s missing years BEFORE the
# map so yearMap(0) -> 1 and the 0 sentinel is unreachable (handleDouban.py:
# 112-113); codes are 1..6 -> a 6-wide block.
N_YEAR_BUCKETS = 6

_NUMBER = re.compile(r"\s*[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\s*",
                     re.IGNORECASE)


def _is_nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def _split_multi(values: List, pattern: str) -> List[List[str]]:
    """``series.fillna("").str.split(pattern)`` exactly (``handleDouban.py:
    87-106``): an empty/NaN cell yields ``['']``, and the empty token is KEPT
    (it becomes an MLB ``''`` genre class / an 'other' language code)."""
    return [re.split(pattern, "" if _is_nan(v) else str(v)) for v in values]


def to_numeric(values: np.ndarray) -> np.ndarray:
    """``pd.to_numeric(values, errors="coerce")`` as float64: numbers stay,
    a string that reads as a number becomes it, anything else NaN."""
    if values.dtype.kind in "iuf":
        return values.astype(np.float64)
    out = np.full(len(values), np.nan)
    for j, v in enumerate(values.tolist()):
        if isinstance(v, (bool, np.bool_)):
            out[j] = float(v)
        elif isinstance(v, (int, float)):
            out[j] = v
        elif isinstance(v, str) and _NUMBER.fullmatch(v):
            out[j] = float(v)
    return out


def douban_user_features(users: Columns, title_dim: int = 3, device="cuda"):
    """(raw md5 ids, nickname embeddings) (``handleDouban.py:29-56``)."""
    emb = text_embeddings(as_str(users["USER_NICKNAME"]), title_dim, device=device)
    return users["USER_MD5"], emb


def douban_item_features(items: Columns, title_dim: int = 3, content_dim: int = 20,
                         device="cuda"):
    """(raw movie ids, concatenated feature rows) (``handleDouban.py:60-157``)."""
    # split as the reference (handleDouban.py:87-106), then its cleaning maps
    # (handleFeature.py:62-144) before the multi-hots
    genres = [clean_genres(row) for row in _split_multi(items["GENRES"].tolist(), r"[ /]")]
    languages = [
        language_codes(row)
        for row in _split_multi(
            ["" if _is_nan(v) else str(v).replace(" ", "") for v in items["LANGUAGES"].tolist()],
            r"[/ |]",
        )
    ]
    regions = [region_codes(row) for row in _split_multi(items["REGIONS"].tolist(), r"[/]")]

    # MultiLabelBinarizer fits classes as the sorted union of observed labels
    genre_vocab = sorted({g for row in genres for g in row})
    lang_vocab = sorted({l for row in languages for l in row})
    region_vocab = sorted({r for row in regions for r in row})

    mins = to_numeric(items["MINS"])
    mins[np.isnan(mins)] = 0.0
    known = mins != 0.0
    # pandas' skip-NaN mean: the sum with the gaps as zeros, over the count
    mean_mins = mins.sum() / known.sum() if known.any() else math.nan
    mins[~known] = mean_mins if not math.isnan(mean_mins) else 90.0
    # the reference buckets the (fractional) mean-imputed FLOAT directly
    duration_oh = np.asarray(
        [one_hot(duration_bucket(float(m)), N_DURATION_BUCKETS) for m in mins.tolist()],
        dtype=np.float32)

    years = to_numeric(items["YEAR"])
    years[np.isnan(years)] = 0
    year_oh = np.asarray([one_hot(year_bucket(y) - 1, N_YEAR_BUCKETS)
                          for y in years.astype(np.int64).tolist()], dtype=np.float32)

    name_emb = text_embeddings(as_str(items["NAME"]), title_dim, device=device)
    story_emb = text_embeddings(as_str(items["STORYLINE"]), content_dim, device=device)

    feats = np.concatenate(
        [
            name_emb,
            multi_hot(genres, genre_vocab),
            multi_hot(languages, lang_vocab),
            duration_oh,
            story_emb,
            multi_hot(regions, region_vocab),
            year_oh,
        ],
        axis=1,
    )
    return items["MOVIE_ID"], feats


def prepare_douban(
    cfg: Config, save_path: Optional[str] = None, device="cuda"
) -> Tuple[RatingSplits, np.ndarray, np.ndarray]:
    """Full Douban pipeline (``prepareDouban``, ``handleDouban.py:160-215``)."""
    log = get_logger()
    paths = cfg.preprocessing.dataset_paths
    with stage_timer("Douban dataset processing done", log):
        rating = read_table(paths["rating"])
        users = read_table(paths["users"])
        items = read_table(paths["items"])

        known = np.isin(rating["MOVIE_ID"], items["MOVIE_ID"])
        rating = {name: col[known] for name, col in rating.items()}
        splits = prepare_ratings(rating, cfg, save_path)

        vs = cfg.preprocessing.vector_size
        user = douban_user_features(users, vs["title"], device)
        item = douban_item_features(items, vs["title"], vs["content"], device)
        user_features, item_features = align_and_save(splits, user, item, save_path)
    return splits, user_features, item_features

"""Seeded raw dataset directories in each distribution's exact file schema.

No dataset ships with the repository and nothing is downloaded: the tests
and ``chip_smoke.py`` write stand-ins with these functions and ingest them
through ``--data-dir`` as they would the real files. The package's pipeline
never calls them.

- ``write_ml100k``: ``u.data`` (tab-separated), ``u.user``, ``u.occupation``
  and ``u.item`` (pipe-separated, latin-1): accented titles, missing
  release dates, a title that opens with a quote and one whose quoted part
  holds the separator, a title pandas reads as NaN ("NA"), an occupation
  that ``u.occupation`` lacks, rated items without a ``u.item`` row and rows
  nobody rated.
- ``write_ml1m``: ``ratings.dat``, ``users.dat`` and ``movies.dat`` (``::``,
  latin-1) for a given rating table, e.g. the synthetic ML-1M stand-in.
- ``write_douban``: ``users.csv``, ``movies.csv`` and ``ratings.csv`` with
  the Douban columns: md5 user ids, storylines with commas, quotes and line
  breaks (quoted), traditional / English genre labels, empty cells, a
  nickname pandas reads as NaN ("None"), ratings of unknown movies.

Python and numpy only (no pandas), so it runs where pandas is not installed, e.g.
    python3 -c "from lgcnhs_tpu_torch.data.raw_standins import write_ml100k; write_ml100k('DIR')"
"""
from __future__ import annotations

import csv
import hashlib
import os
from typing import Dict, Optional

import numpy as np

OCCUPATIONS = ["administrator", "artist", "doctor", "educator", "engineer",
               "entertainment", "executive", "healthcare", "homemaker", "lawyer",
               "librarian", "marketing", "none", "other", "programmer", "retired",
               "salesman", "scientist", "student", "technician", "writer"]
GENRES_1M = ["Action", "Adventure", "Animation", "Children's", "Comedy", "Crime",
             "Documentary", "Drama", "Fantasy", "Film-Noir", "Horror", "Musical",
             "Mystery", "Romance", "Sci-Fi", "Thriller", "War", "Western"]
WORDS = ["night", "city", "love", "story", "return", "dark", "river", "king", "war",
         "secret", "garden", "summer", "blue", "last", "man", "woman", "house", "star",
         "dream", "road", "fire", "island", "ghost", "heart", "time", "little", "big",
         "caf\xe9", "na\xefve", "se\xf1or", "\xfcber", "gar\xe7on", "ann\xe9e", "m\xe8re"]
MONTHS = ["Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep", "Oct", "Nov", "Dec"]
ZH_WORDS = ["城市", "爱情", "故事", "夜晚", "河流", "国王", "战争", "秘密", "花园", "夏天",
            "星星", "梦想", "道路", "火焰", "岛屿", "时间", "家庭", "朋友", "少年", "英雄"]
DOUBAN_GENRES = ["剧情", "喜剧", "动作", "爱情", "科幻", "动画", "悬疑", "惊悚", "恐怖",
                 "纪录片", "動畫", "Comedy", "Drama", "Animation", "喜劇", "家庭"]
DOUBAN_LANGUAGES = ["汉语普通话", "英语", "日语", "法语", "粤语", "德语"]
DOUBAN_REGIONS = ["中国大陆", "美国", "香港", "日本", "法国", "英国"]


def _title(rng: np.random.Generator, n_words: int) -> str:
    words = rng.choice(WORDS, size=n_words)
    return " ".join(w.capitalize() for w in words)


def _interactions(rng, n_users, n_items, n_ratings):
    """(users, items) 1-based, unique pairs, lognormal user activity and
    Zipf item popularity, in draw order."""
    act = rng.lognormal(0.0, 1.0, n_users)
    pop = 1.0 / np.arange(1, n_items + 1) ** 0.9
    rng.shuffle(pop)
    keys = np.empty(0, np.int64)
    while keys.size < n_ratings:
        u = rng.choice(n_users, size=2 * n_ratings, p=act / act.sum())
        i = rng.choice(n_items, size=2 * n_ratings, p=pop / pop.sum())
        keys = np.concatenate([keys, u.astype(np.int64) * n_items + i])
        _, first = np.unique(keys, return_index=True)
        keys = keys[np.sort(first)]
    keys = keys[:n_ratings]
    return keys // n_items + 1, keys % n_items + 1


def write_ml100k(data_dir: str, n_users: int = 943, n_items: int = 1682,
                 n_ratings: int = 100_000, seed: int = 0) -> Dict[str, str]:
    """An ML-100K directory at the given size (the distribution's by default)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    users, items = _interactions(rng, n_users, n_items + 2, n_ratings)
    ratings = rng.integers(1, 6, n_ratings)
    stamps = rng.integers(874_724_710, 893_286_638, n_ratings)
    with open(os.path.join(data_dir, "u.data"), "w") as f:
        f.writelines(f"{u}\t{i}\t{r}\t{t}\n" for u, i, r, t in zip(users, items, ratings, stamps))
    with open(os.path.join(data_dir, "u.occupation"), "w") as f:
        f.writelines(f"{o}\n" for o in OCCUPATIONS)
    with open(os.path.join(data_dir, "u.user"), "w") as f:
        for u in range(1, n_users + 1):
            occ = "pilot" if u % 97 == 0 else OCCUPATIONS[int(rng.integers(len(OCCUPATIONS)))]
            zip_code = f"T{u % 10}H1N" if u % 50 == 0 else f"{int(rng.integers(10000, 99999))}"
            f.write(f"{u}|{int(rng.integers(7, 74))}|{'MF'[int(rng.integers(2))]}|{occ}|"
                    f"{zip_code}\n")
    # rated ids n_items+1 and n_items+2 have no u.item row; some rows go unrated
    with open(os.path.join(data_dir, "u.item"), "w", encoding="iso-8859-1") as f:
        for i in range(1, n_items + 1):
            year = int(rng.integers(1922, 1999))
            title = f"{_title(rng, int(rng.integers(1, 4)))} ({year})"
            if i % 211 == 0:
                title = f'"{_title(rng, 1)}" {title}'  # opens with a quote
            elif i % 307 == 0:
                title = f'"{_title(rng, 1)}|{_title(rng, 1)}" ({year})'  # quoted separator
            elif i == 5:
                title = "NA"
            date = "" if i % 150 == 3 else f"{int(rng.integers(1, 29)):02d}-{MONTHS[i % 12]}-{year}"
            flags = (rng.random(19) < 0.12).astype(int)
            flags[0] = int(not flags.any())
            f.write(f"{i}|{title}|{date}||http://us.imdb.com/M/title-exact?{i}|"
                    + "|".join(map(str, flags)) + "\n")
    return {"rating": os.path.join(data_dir, "u.data"),
            "users": os.path.join(data_dir, "u.user"),
            "items": os.path.join(data_dir, "u.item"),
            "occupation": os.path.join(data_dir, "u.occupation")}


def write_ml1m(data_dir: str, table: Dict[str, np.ndarray], seed: int = 0) -> Dict[str, str]:
    """An ML-1M directory holding ``table`` (columns user, item, rating,
    timestamp; positive ints) as ``ratings.dat``, with a ``users.dat`` and a
    ``movies.dat`` row for every id up to the largest."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    cols = [np.asarray(table[c]).tolist() for c in ("user", "item", "rating", "timestamp")]
    with open(os.path.join(data_dir, "ratings.dat"), "w") as f:
        f.writelines(f"{u}::{i}::{r}::{t}\n" for u, i, r, t in zip(*cols))
    ages = [1, 18, 25, 35, 45, 50, 56]
    with open(os.path.join(data_dir, "users.dat"), "w") as f:
        for u in range(1, int(max(cols[0])) + 1):
            f.write(f"{u}::{'MF'[int(rng.integers(2))]}::{ages[int(rng.integers(7))]}::"
                    f"{int(rng.integers(21))}::{int(rng.integers(10000, 99999))}\n")
    with open(os.path.join(data_dir, "movies.dat"), "w", encoding="iso-8859-1") as f:
        for i in range(1, int(max(cols[1])) + 1):
            title = _title(rng, int(rng.integers(1, 4)))
            if i % 9:
                title += f" ({int(rng.integers(1919, 2001))})"
            genres = rng.choice(GENRES_1M, size=int(rng.integers(1, 4)), replace=False)
            f.write(f"{i}::{title}::{'|'.join(genres)}\n")
    return {"rating": os.path.join(data_dir, "ratings.dat"),
            "users": os.path.join(data_dir, "users.dat"),
            "items": os.path.join(data_dir, "movies.dat")}


def _story(rng: np.random.Generator, n_words: int) -> str:
    words = [str(w) for w in rng.choice(WORDS[:27] + ZH_WORDS, size=n_words)]
    for j in range(7, n_words, 11):
        words[j] += ","
    if n_words > 20:
        words[20] = '"' + words[20] + '"'
        words[-1] += ".\nThe end"
    return " ".join(words)


def write_douban(data_dir: str, n_users: int = 300, n_movies: int = 120,
                 n_ratings: int = 6000, story_words: int = 30, seed: int = 0,
                 unknown_movies: int = 3, mins_text: Optional[str] = None) -> Dict[str, str]:
    """A Douban directory (``users.csv``, ``movies.csv``, ``ratings.csv``).
    ``mins_text``: a non-numeric MINS cell, which makes the column text."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    md5 = [hashlib.md5(f"user{u}".encode()).hexdigest() for u in range(n_users)]
    paths = {"users": os.path.join(data_dir, "users.csv"),
             "items": os.path.join(data_dir, "movies.csv"),
             "rating": os.path.join(data_dir, "ratings.csv")}
    with open(paths["users"], "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["USER_MD5", "USER_NICKNAME"])
        # nicknames of 1-3 words, drawn for every user at once
        n_words = rng.integers(1, 4, n_users).tolist()
        words = rng.choice(WORDS[:27] + ZH_WORDS, size=(n_users, 3)).tolist()
        w.writerows([m, "None" if u == 3 else " ".join(words[u][:n_words[u]])]
                    for u, m in enumerate(md5))
    movie_ids = np.sort(rng.choice(np.arange(1_290_000, 1_300_000), size=n_movies,
                                   replace=False))
    columns = ["MOVIE_ID", "NAME", "ALIAS", "ACTORS", "COVER", "DIRECTORS",
               "DOUBAN_SCORE", "DOUBAN_VOTES", "GENRES", "IMDB_ID", "LANGUAGES", "MINS",
               "OFFICIAL_SITE", "REGIONS", "RELEASE_DATE", "SLUG", "STORYLINE", "TAGS",
               "YEAR", "ACTOR_IDS", "DIRECTOR_IDS"]
    with open(paths["items"], "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(columns)
        for j, mid in enumerate(movie_ids.tolist()):
            genres = "" if j % 17 == 5 else "/".join(
                rng.choice(DOUBAN_GENRES, size=int(rng.integers(1, 4)), replace=False))
            langs = "" if j % 13 == 4 else " / ".join(
                rng.choice(DOUBAN_LANGUAGES, size=int(rng.integers(1, 3)), replace=False))
            regions = "" if j % 19 == 7 else "/".join(
                rng.choice(DOUBAN_REGIONS, size=int(rng.integers(1, 3)), replace=False))
            mins = "" if j % 11 == 2 else ("0" if j % 11 == 6 else str(int(rng.integers(20, 200))))
            if mins_text is not None and j == 1:
                mins = mins_text
            year = "" if j % 23 == 9 else str(int(rng.integers(1950, 2020)))
            row = {"MOVIE_ID": mid, "NAME": f"{rng.choice(ZH_WORDS)} {_title(rng, 2)}",
                   "GENRES": genres, "LANGUAGES": langs, "MINS": mins, "REGIONS": regions,
                   "STORYLINE": _story(rng, story_words), "YEAR": year,
                   "DOUBAN_SCORE": f"{rng.uniform(2, 9.5):.1f}",
                   "DOUBAN_VOTES": int(rng.integers(0, 100_000))}
            w.writerow([row.get(c, "") for c in columns])
    users, items = _interactions(rng, n_users, n_movies, n_ratings)
    stars = rng.integers(1, 6, n_ratings).tolist()
    month, day, hour = (rng.integers(1, hi, n_ratings).tolist() for hi in (10, 29, 24))
    ids = movie_ids[items - 1].tolist()
    with open(paths["rating"], "w", newline="", encoding="utf-8") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["USER_MD5", "MOVIE_ID", "RATING", "RATING_TIME"])
        w.writerows([md5[u - 1], m, r, f"2019-0{mo}-{d:02d} {h:02d}:00:00"]
                    for u, m, r, mo, d, h in zip(users.tolist(), ids, stars, month, day, hour))
        for j in range(unknown_movies):  # movies missing from movies.csv
            w.writerow([md5[j], 999 + j, 5, "2019-01-01 00:00:00"])
    return paths

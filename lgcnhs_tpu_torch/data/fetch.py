"""Opt-in dataset acquisition (ML-100K and ML-1M).

Port of ``lgcnhs_tpu/data/fetch.py`` (a copy; the logger is the port's).
The reference assumes the raw files already sit at hardcoded local paths
(``const.py:200-244``); this module gives the pipeline an acquisition path
so that the moment an environment has network egress, accuracy-vs-reference
numbers are one ``--fetch`` away. Download is strictly opt-in (CLI flag),
checksummed, and degrades to a logged no-op without egress — the synthetic
stand-in dataset keeps everything runnable offline.
"""
from __future__ import annotations

import hashlib
import os
import zipfile
from typing import Dict, Optional

from lgcnhs_tpu_torch.runtime.logging import get_logger

ML100K_URL = "https://files.grouplens.org/datasets/movielens/ml-100k.zip"
# Published by GroupLens alongside the archive (ml-100k.zip).
ML100K_MD5 = "0e33842e24a9c977be4e0107933c0723"
# The four files the pipeline consumes (handleMovielens.py:122-172).
ML100K_FILES = {
    "rating": "u.data",
    "users": "u.user",
    "items": "u.item",
    "occupation": "u.occupation",
}

ML1M_URL = "https://files.grouplens.org/datasets/movielens/ml-1m.zip"
# Published by GroupLens alongside the archive (ml-1m.zip).
ML1M_MD5 = "c4d9eecfca2ab87c1945afe126590906"
# The three files the 1M pipeline consumes (data/movielens1m.py).
ML1M_FILES = {
    "rating": "ratings.dat",
    "users": "users.dat",
    "items": "movies.dat",
}


def ml100k_paths(data_dir: str) -> Dict[str, str]:
    """dataset_paths dict for an extracted ml-100k directory."""
    return {key: os.path.join(data_dir, name) for key, name in ML100K_FILES.items()}


def ml1m_paths(data_dir: str) -> Dict[str, str]:
    """dataset_paths dict for an extracted ml-1m directory."""
    return {key: os.path.join(data_dir, name) for key, name in ML1M_FILES.items()}


#: Douban movie-dataset CSVs, named as the reference configures them
#: (``const.py:225-227``: users.csv / movies.csv / ratings.csv). There is no
#: fetcher — the dataset has no canonical public archive — but ``--data-dir``
#: must still be able to point at a local copy.
DOUBAN_FILES = {
    "rating": "ratings.csv",
    "users": "users.csv",
    "items": "movies.csv",
}


def douban_paths(data_dir: str) -> Dict[str, str]:
    """dataset_paths dict for a directory of Douban CSVs."""
    return {key: os.path.join(data_dir, name) for key, name in DOUBAN_FILES.items()}


def have_ml100k(data_dir: str) -> bool:
    return all(os.path.exists(p) for p in ml100k_paths(data_dir).values())


def have_ml1m(data_dir: str) -> bool:
    return all(os.path.exists(p) for p in ml1m_paths(data_dir).values())


def _fetch_archive(
    dest_dir: str,
    archive_name: str,
    member_dir: str,
    files: Dict[str, str],
    url: str,
    md5: Optional[str],
    timeout: float,
) -> Optional[Dict[str, str]]:
    """Download + md5-verify + extract a GroupLens-style zip whose members
    live under ``member_dir/``. Returns the dataset_paths dict, or None when
    the files can't be obtained (no egress, checksum mismatch, bad archive)
    — callers fall back to the synthetic stand-in exactly as when raw files
    are absent."""
    log = get_logger()
    data_dir = os.path.join(dest_dir, member_dir)
    paths = {key: os.path.join(data_dir, name) for key, name in files.items()}
    if all(os.path.exists(p) for p in paths.values()):
        log.info("%s already present at %s", member_dir, data_dir)
        return paths

    import urllib.error
    import urllib.request

    os.makedirs(dest_dir, exist_ok=True)
    zip_path = os.path.join(dest_dir, archive_name)
    try:
        log.info("fetching %s", url)
        with urllib.request.urlopen(url, timeout=timeout) as resp, open(
            zip_path, "wb"
        ) as out:
            while True:
                chunk = resp.read(1 << 20)
                if not chunk:
                    break
                out.write(chunk)
    except (urllib.error.URLError, OSError, TimeoutError) as exc:
        log.warning("%s fetch failed (no egress?): %s", archive_name, exc)
        return None

    if md5:
        digest = hashlib.md5()
        with open(zip_path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 20), b""):
                digest.update(chunk)
        if digest.hexdigest() != md5:
            log.error(
                "%s checksum mismatch: got %s want %s — refusing",
                archive_name, digest.hexdigest(), md5,
            )
            os.unlink(zip_path)
            return None

    with zipfile.ZipFile(zip_path) as z:
        wanted = {f"{member_dir}/{name}" for name in files.values()}
        members = [m for m in z.namelist() if m in wanted]
        if len(members) != len(wanted):
            log.error(
                "%s missing expected members: %s", archive_name, wanted - set(members)
            )
            return None
        z.extractall(dest_dir, members=members)
    os.unlink(zip_path)
    log.info("%s extracted to %s", member_dir, data_dir)
    return paths


def fetch_ml100k(
    dest_dir: str,
    url: str = ML100K_URL,
    md5: Optional[str] = ML100K_MD5,
    timeout: float = 60.0,
) -> Optional[Dict[str, str]]:
    """Download + verify + extract ML-100K into ``dest_dir/ml-100k``."""
    return _fetch_archive(
        dest_dir, "ml-100k.zip", "ml-100k", ML100K_FILES, url, md5, timeout
    )


def fetch_ml1m(
    dest_dir: str,
    url: str = ML1M_URL,
    md5: Optional[str] = ML1M_MD5,
    timeout: float = 120.0,
) -> Optional[Dict[str, str]]:
    """Download + verify + extract ML-1M (~6 MB) into ``dest_dir/ml-1m``."""
    return _fetch_archive(
        dest_dir, "ml-1m.zip", "ml-1m", ML1M_FILES, url, md5, timeout
    )

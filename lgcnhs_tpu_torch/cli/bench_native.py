"""Native graph-builder micro-benchmark at >=10M-row scale.

Port of ``lgcnhs_tpu/cli/bench_native.py``: times the C++ ingestion
functions (``native/graph_builder.cc``, ctypes-bound) against the fallbacks
the port takes without them, on the same data, and checks they agree:

- ``parse_edges_csv``: integer-id CSV -> (users, items), against the port's
  CSV reader (``runtime/table.read_table``; JAX times pandas here)
- ``parse_rating_rows``: ML-1M-style ``::`` rating rows, against the same
  reader's ``::`` split (pandas' python engine in JAX)
- ``build_csr``: COO -> deduplicated sorted CSR, the structure the large-graph
  stages consume (``ops/scalable.user_csr``), against the bindings' numpy
  fallback (``build_csr_numpy``)

Usage: python -m lgcnhs_tpu_torch.cli.bench_native [--rows 10000000]
Prints one JSON line with the measured seconds and speedups (host only).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def log(msg: str) -> None:
    print(f"[bench_native] {msg}", file=sys.stderr, flush=True)


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--rows", type=int, default=10_000_000)
    p.add_argument("--users", type=int, default=500_000)
    p.add_argument("--items", type=int, default=200_000)
    args = p.parse_args(argv)

    from lgcnhs_tpu_torch.native import bindings
    from lgcnhs_tpu_torch.runtime.table import read_table

    if not bindings.available():
        log("native library unavailable; nothing to compare")
        print(json.dumps({"native": False}))
        return {"native": False}

    rng = np.random.default_rng(0)
    users = rng.integers(0, args.users, args.rows).astype(np.int32)
    items = rng.integers(0, args.items, args.rows).astype(np.int32)
    out = {"native": True, "rows": args.rows}

    def compare(key, path, native_fn, reader_fn, check):
        log(f"{os.path.basename(path)}: {os.path.getsize(path) / 1e6:.0f} MB")
        got, t_native = _timed(native_fn)
        want, t_reader = _timed(reader_fn)
        check(got, want)
        out[f"{key}_native_s"] = round(t_native, 3)
        out[f"{key}_reader_s"] = round(t_reader, 3)
        out[f"{key}_speedup"] = round(t_reader / t_native, 2)
        log(f"{key}: native {t_native:.2f}s vs reader {t_reader:.2f}s "
            f"({t_reader / t_native:.1f}x)")

    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "edges.csv")
        with open(csv_path, "w") as f:
            f.write("user_id,item_id\n")
            np.savetxt(f, np.stack([users, items], axis=1), fmt="%d", delimiter=",")

        def check_edges(got, want):
            np.testing.assert_array_equal(got[0], want["user_id"])
            np.testing.assert_array_equal(got[1], want["item_id"])

        compare("parse", csv_path, lambda: bindings.parse_edges_csv(csv_path),
                lambda: read_table(csv_path), check_edges)

        # ML-1M-style ::-separated rating rows
        ratings = rng.integers(1, 6, args.rows).astype(np.int32)
        stamps = rng.integers(9e8, 1e9, args.rows).astype(np.int32)
        dat_path = os.path.join(tmp, "ratings.dat")
        with open(dat_path, "w") as f:
            np.savetxt(f, np.stack([users, items, ratings, stamps], axis=1),
                       fmt="%d", delimiter="::")

        def check_rows(got, want):
            assert got is not None and len(got[0]) == args.rows
            for col, name in zip(got, ("user", "item", "rating", "timestamp")):
                np.testing.assert_array_equal(col, want[name])

        compare("ratings", dat_path, lambda: bindings.parse_rating_rows(dat_path, "::"),
                lambda: read_table(dat_path, sep="::",
                                   names=["user", "item", "rating", "timestamp"]),
                check_rows)

    (indptr_n, idx_n), t_native = _timed(lambda: bindings.build_csr(users, items, args.users))
    (indptr_f, idx_f), t_numpy = _timed(
        lambda: bindings.build_csr_numpy(users, items, args.users))
    np.testing.assert_array_equal(indptr_n, indptr_f)
    np.testing.assert_array_equal(idx_n, idx_f)
    out["csr_native_s"] = round(t_native, 3)
    out["csr_numpy_s"] = round(t_numpy, 3)
    out["csr_speedup"] = round(t_numpy / t_native, 2)
    log(f"build_csr: native {t_native:.2f}s vs numpy {t_numpy:.2f}s "
        f"({t_numpy / t_native:.1f}x)")

    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

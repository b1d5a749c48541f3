"""``lgcnhs_tpu_torch.native`` against ``lgcnhs_tpu.native``: the port's copy
of the C++ graph builder, built into its git-ignored ``_build/`` directory,
gives identical parses and CSR; so do its
fallbacks without the library (numpy and the port's CSV reader, where JAX
reads with pandas); ``ops/scalable.user_csr`` builds through it as JAX's
does; ``cli/bench_native`` runs at a small size.
"""
import json
import os
import subprocess

import numpy as np
import pytest

from lgcnhs_tpu.data.graph import EdgeSet as JEdgeSet
from lgcnhs_tpu.native import bindings as jb
from lgcnhs_tpu.ops import scalable as jscalable
from lgcnhs_tpu_torch.cli import bench_native
from lgcnhs_tpu_torch.data.graph import EdgeSet as TEdgeSet
from lgcnhs_tpu_torch.native import bindings as tb
from lgcnhs_tpu_torch.ops import scalable as tscalable

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def fallback(monkeypatch):
    """The port's bindings as on a machine without a compiler."""
    monkeypatch.setattr(tb, "_lib", None)
    monkeypatch.setattr(tb, "_tried", True)


def test_library_builds_into_an_ignored_directory():
    assert tb.available(), "g++ build of the port's graph_builder.cc failed"
    assert os.path.dirname(tb._LIB_PATH) == tb._BUILD_DIR and os.path.exists(tb._LIB_PATH)
    rel = os.path.relpath(tb._LIB_PATH, REPO)
    ignored = subprocess.run(["git", "check-ignore", "-q", rel], cwd=REPO)
    assert ignored.returncode == 0, f"{rel} is not git-ignored"
    # the port keeps a subset of JAX's functions, each line as JAX has it
    with open(tb._SRC) as a, open(jb._SRC) as b:
        port, jax_src = [[line for line in f.read().splitlines() if not line.startswith("//")]
                         for f in (a, b)]
    rest = iter(jax_src)
    assert all(line in rest for line in port), "a line of the port's copy is not JAX's"
    assert "int64_t build_csr(" in "\n".join(port)


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_parse_edges_matches_jax(native, tmp_path, request):
    if not native:
        request.getfixturevalue("fallback")
    path = tmp_path / "edges.csv"
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 10_000, (3000, 4))
    path.write_text("user_id,item_id,rating,ts\n" + "".join(f"{a},{b},{c},{d}\n"
                                                            for a, b, c, d in rows))
    for got, want in zip(tb.parse_edges_csv(str(path)), jb.parse_edges_csv(str(path))):
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sep", ["::", "\t", ","])
def test_parse_rating_rows_matches_jax(sep, tmp_path):
    rng = np.random.default_rng(1)
    rows = rng.integers(1, 2_000_000_000, (5000, 4))
    path = tmp_path / "ratings.dat"
    path.write_text("".join(sep.join(map(str, r)) + "\n" for r in rows))
    got, want = tb.parse_rating_rows(str(path), sep), jb.parse_rating_rows(str(path), sep)
    assert got is not None and len(got) == 4
    for g, w, col in zip(got, want, rows.T):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, col)
    path.write_text("1::2::3::x\n")  # malformed: the callers fall back
    assert tb.parse_rating_rows(str(path), "::") is None


def test_parse_rating_rows_without_the_library_defers(fallback, tmp_path):
    path = tmp_path / "r.dat"
    path.write_text("1::2::3::4\n")
    assert tb.parse_rating_rows(str(path), "::") is None


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_csr_matches_jax(native, request):
    if not native:
        request.getfixturevalue("fallback")
    rng = np.random.default_rng(2)
    rows = rng.integers(0, 300, 80_000).astype(np.int32)
    cols = rng.integers(0, 500, 80_000).astype(np.int32)
    for got, want in zip(tb.build_csr(rows, cols, 300), jb.build_csr(rows, cols, 300)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_user_csr_builds_through_the_native_builder(monkeypatch):
    rng = np.random.default_rng(3)
    users = rng.integers(0, 40, 900).astype(np.int32)
    items = rng.integers(0, 70, 900).astype(np.int32)
    want = jscalable.user_csr(40, JEdgeSet(users, items))
    calls = []
    build = tb.build_csr
    monkeypatch.setattr(tb, "build_csr", lambda *a: calls.append(a) or build(*a))
    got = tscalable.user_csr(40, TEdgeSet(users, items))
    assert len(calls) == 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_bench_native_runs_small(capsys):
    out = bench_native.main(["--rows", "20000", "--users", "500", "--items", "300"])
    assert out["native"] and out["rows"] == 20000
    assert {"parse_speedup", "ratings_speedup", "csr_speedup"} <= set(out)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out

"""``bench_torch.py`` (the port's bench) on the CPU at tiny sizes, beside
``bench.py`` where both compute the same thing.

The module constants are shrunk as ``tests/test_bench_smoke.py`` shrinks
``bench.py``'s: 40 x 60 users and items, 1500 interactions, D=8, batch 32,
K=5 (K_PROD 20), 3 lambda points, the large graph 50 x 30 with 400 edges,
the tall catalog 20 x 1000 with 4000 edges (1000 items: whole blocks of
500), timed regions of ~10 ms. Checked:

- ``build_problem``'s edges are identical to ``bench.build_problem``'s, its
  hyperparameters equal;
- every row runs on the CPU with positive rates and ``STATS`` entries of
  n >= 5; the headline is the trainer's CPU route at the prod preset;
- the tall diffusion's factored and blocked scores agree within 1e-5 of
  scale, and both match the JAX ``user_factored_diffusion_scores`` on the
  same A within 1e-5 of scale (f32 sums in another order);
- the streaming row's agreement with matmul + ``masked_topk`` is 1.0 (the
  wrapper runs its twin on the CPU);
- the contract rules (``kernel_contracts``, tie-equivalence) on CPU tensors;
- ``_run_row`` records an error and returns None; ``main`` exits 0 with
  every row passing and 1 when a row or the headline fails, printing the
  line either way, its side file under ``--out-dir`` only;
- ``format_record`` stays within 1500 characters under oversized extras,
  keeps every key of a card run's line, has ``bench.format_record``'s
  top-level keys;
- ``bench_torch.py`` imports no ``jax``, no ``lgcnhs_tpu`` and no pandas at
  its top level.
"""
import ast
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import bench_torch
from lgcnhs_tpu.ops.diffusion import user_factored_diffusion_scores as j_factored
from lgcnhs_tpu_torch.eval import reference_runner
from lgcnhs_tpu_torch.ops import diffusion as tdiff

CPU = torch.device("cpu")
SHARED = {"N_USERS": 40, "N_ITEMS": 60, "N_INTERACTIONS": 1500, "EMBED_DIM": 8,
          "BATCH": 32, "K": 5}
PORT_ONLY = {"K_PROD": 20, "LAMBDA_POINTS": 3, "REF_SWEEP_ITERS": 1, "CPU_STEPS": 2,
             "SWEEP_USERS": 40, "SWEEP_ITEMS": 60, "SWEEP_INTERACTIONS": 1500,
             "LARGE_USERS": 50, "LARGE_ITEMS": 30, "LARGE_EDGES": 400,
             "TALL_USERS": 20, "TALL_ITEMS": 1000, "TALL_EDGES": 4000, "REGION_S": 0.01}


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    """(cfg, hp, graph, provenance) of the shrunk port problem; fresh
    module records; no reference checkout."""
    for mod in (bench, bench_torch):
        for name, value in SHARED.items():
            monkeypatch.setattr(mod, name, value)
    for name, value in PORT_ONLY.items():
        monkeypatch.setattr(bench_torch, name, value)
    for name in ("STATS", "ROWS", "RUN", "CONTRACTS"):
        monkeypatch.setattr(bench_torch, name, {})
    monkeypatch.setattr(reference_runner, "REF_ROOT", tmp_path / "no-reference")
    return bench_torch.build_problem()


def test_build_problem_matches_the_jax_bench(tiny):
    cfg, hp, graph, provenance = tiny
    _, j_hp, j_graph, j_provenance = bench.build_problem()
    assert provenance == j_provenance == "synthetic-ml1m-scale"
    assert (graph.n_users, graph.n_items) == (j_graph.n_users, j_graph.n_items)
    for split in ("all", "train", "val", "test"):
        for side in ("users", "items"):
            np.testing.assert_array_equal(getattr(getattr(graph, split), side),
                                          getattr(getattr(j_graph, split), side),
                                          err_msg=f"{split}.{side}")
    assert dataclasses.asdict(hp) == dataclasses.asdict(j_hp)
    assert (hp.batch_size, hp.embedding_dim) == (32, 8)


@pytest.mark.parametrize("variant", ["f32", "bf16", "binary"])
def test_train_rows_run_tiny(tiny, variant):
    _, hp, graph, _ = tiny
    assert bench_torch.bench_train(CPU, hp, graph, 2, variant) > 0
    assert bench_torch.STATS[f"train_{variant}"]["n"] >= 5


def test_headline_is_the_trainers_cpu_route(tiny):
    """On the CPU ``train_lightgcn`` takes the plain bf16 dense route at the
    prod preset (no kernels off CUDA); with the f32 preset, the f32 one."""
    cfg, _, graph, _ = tiny
    assert bench_torch.headline_variant(cfg, graph, CPU) == "bf16"
    f32 = cfg.replace(compute=dataclasses.replace(cfg.compute, dtype="float32"))
    assert bench_torch.headline_variant(f32, graph, CPU) == "f32"


def test_large_graph_rows_run_tiny(tiny):
    _, hp, _, _ = tiny
    assert bench_torch.bench_train_coo(CPU, hp, 2) > 0
    assert bench_torch.bench_train_dense_rung(CPU, hp, n_steps=4, chunk=2) > 0
    for name in ("train_coo_50kx30k", "train_densebf16_50kx30k"):
        assert bench_torch.STATS[name]["n"] >= 5


def test_serving_rows_run_tiny(tiny):
    cfg, _, graph, _ = tiny
    qps, qps_steady = bench_torch.bench_retrieval(CPU, graph, k=5, reps=2)
    assert qps > 0 and qps_steady > 0
    sq, sq_steady = bench_torch.bench_serve_fused(CPU, graph, cfg.hparams.lambda_, k=20, reps=2)
    assert sq > 0 and sq_steady > 0
    for name in ("retrieval_k5", "retrieval_k5_steady", "serve_fused_k20",
                 "serve_fused_k20_steady"):
        assert bench_torch.STATS[name]["n"] >= 5, name


def test_diffusion_tall_row_matches_jax(tiny):
    fact_s, blk_s, gap = bench_torch.bench_diffusion_tall(CPU)
    assert fact_s > 0 and blk_s > 0
    assert gap <= 1e-5
    A = bench_torch.tall_incidence()
    assert A.shape == (20, 1000) and A.sum() > 0
    want = np.asarray(j_factored(jnp.asarray(A), jnp.float32(0.6)))
    At = torch.from_numpy(A)
    for got in (tdiff.user_factored_diffusion_scores(At, 0.6),
                tdiff.blocked_diffusion_scores(At, 0.6, block=500)):
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= 1e-5, err


@pytest.mark.parametrize("k", [100, 1000])
def test_streaming_row_agrees_on_cpu(tiny, k):
    sq, lq, agree = bench_torch.bench_streaming_retrieval(CPU, k, n_items=2000, n_users=32)
    assert sq > 0 and lq > 0
    assert agree == 1.0
    tag = "2k" + ("" if k == 100 else f"_k{k}")
    assert bench_torch.STATS[f"retrieval_stream_{tag}"]["n"] >= 5
    assert bench_torch.STATS[f"retrieval_stream_xla_{tag}"]["n"] >= 5


def test_sweep_and_reference_rows_without_a_checkout(tiny):
    ours_s, ref_iter_s = bench_torch.bench_lambda_sweep(CPU)
    assert ours_s > 0 and ref_iter_s is None
    assert bench_torch.STATS["lambda_sweep_101pts"]["n"] >= 5
    assert bench_torch.bench_reference_diffusion(CPU) == (None, None)


def test_kernel_contract_rules(tiny):
    """Identical ids pass; a swap of two tied items in one list of 100
    passes as tie-equivalent; an item of another score fails; a kernel no
    row held fails; the CPU skips. ``dual_matmul`` and fused serving on the
    CPU wrappers (their twins) pass."""
    from lgcnhs_tpu_torch.ops.cuda.fusion_serve import fused_lgcnhs_serve_ref

    ue = torch.tensor([[1.0, 0.0]]).repeat(100, 1)  # items 0 and 1 tie on top
    ie = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.5, 0.5], [0.0, 1.0]])
    seen = torch.zeros((100, 4), dtype=torch.bool)
    want = torch.tensor([[0, 1]], dtype=torch.int32).repeat(100, 1)
    bench_torch.hold_retrieval("fused_topk_retrieval", "same", want, ue, ie, seen, 2)
    swapped = want.clone()
    swapped[7] = torch.tensor([1, 0])
    bench_torch.hold_retrieval("streaming_topk_retrieval", "tie", swapped, ue, ie, seen, 2)
    assert [c["ok"] for c in bench_torch.CONTRACTS["fused_topk_retrieval"]] == [True]
    assert [c["ok"] for c in bench_torch.CONTRACTS["streaming_topk_retrieval"]] == [True]
    assert bench_torch.kernel_contracts(False) == "skipped (cpu)"
    assert bench_torch.kernel_contracts(True) == [
        "dual_matmul: no row held it against its twin",
        "fused_lgcnhs_serve: no row held it against its twin"]
    wrong = want.clone()
    wrong[3, 1] = 2  # 0.5 where a 1.0 was due
    bench_torch.hold_retrieval("fused_topk_retrieval", "wrong", wrong, ue, ie, seen, 2)
    gen = torch.Generator().manual_seed(0)
    R = (torch.rand((6, 4), generator=gen) < 0.5).to(torch.int8)
    X, Y = torch.randn(4, 3, generator=gen).bfloat16(), torch.randn(6, 3, generator=gen).bfloat16()
    bench_torch.hold_dual("dual", R, X, Y)
    A = (torch.rand((100, 4), generator=gen) < 0.5).float()
    W = torch.rand((4, 4), generator=gen)
    got = fused_lgcnhs_serve_ref(ue, ie, A, W, A > 0, 2)[0]
    bench_torch.hold_serve("serve", got, ue, ie, A, W, A > 0, 2)
    fails = bench_torch.kernel_contracts(True)
    assert len(fails) == 1 and fails[0].startswith("fused_topk_retrieval @ wrong: agreement 0.995")


def test_run_row_records_the_error_and_returns_none(tiny):
    extra = {}

    def dead():
        raise RuntimeError("CUDA error 700 (an illegal memory access was encountered)")

    assert bench_torch._run_row(extra, "dead_row", dead) is None
    assert extra["row_errors"] == [
        "dead_row: RuntimeError: CUDA error 700 (an illegal memory access was encountered)"]
    assert bench_torch._run_row(extra, "live_row", lambda: 42) == 42
    assert len(extra["row_errors"]) == 1
    assert set(bench_torch.ROWS) == {"dead_row", "live_row"}
    assert bench_torch.ROWS["live_row"]["launches"] == {
        "dual_matmul": 0, "fused_topk_retrieval": 0, "fused_lgcnhs_serve": 0}


@pytest.mark.parametrize("failing", [None, "bench_diffusion_tall", "bench_train"])
def test_main_exit_code(tiny, monkeypatch, tmp_path, capsys, failing):
    """Every row passing: exit 0. A row that raises: its error recorded and
    exit 1; ``bench_train`` raising also loses the headline (and the CPU
    baseline). The line is printed in every case; the side file lands in
    ``--out-dir`` and never in the repository root."""
    if failing:
        def boom(*a, **kw):
            raise RuntimeError(f"{failing} broke")

        monkeypatch.setattr(bench_torch, failing, boom)
    root_side = os.path.join(bench_torch.ROOT, bench_torch.STATS_FILE)
    existed = os.path.exists(root_side)
    out_dir = tmp_path / "out"
    rc = bench_torch.main(["--device", "cpu", "--out-dir", str(out_dir)])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(line) <= 1500
    rec = json.loads(line)
    assert rec["metric"] == "lightgcn_train_examples_per_sec_ml1m"
    assert rec["unit"] == "examples/s/card"
    extra = rec["extra"]
    assert extra["kernel_contracts"] == "skipped (cpu)"
    side = json.loads((out_dir / bench_torch.STATS_FILE).read_text())
    assert side["run"]["problem"]["train_edges"] == 604
    assert os.path.exists(root_side) == existed
    if failing is None:
        assert rc == 0
        assert "row_errors" not in extra and "headline_missing" not in extra
        assert rec["value"] > 0 and rec["vs_baseline"] > 0
        for key in ("train_bf16_kernel_eps", "cpu_f32_eps", "train_coo_50kx30k_eps",
                    "diffusion_tall_factored_s", "retrieval_qps", "retrieval_qps_k20_steady",
                    "serve_fused_qps", "serve_fused_qps_k20", "lambda_sweep_101pts_s"):
            assert extra[key] > 0, key
        assert all(s["n"] >= 5 for s in side["stats"].values())
    else:
        assert rc == 1
        row = "diffusion_tall" if failing == "bench_diffusion_tall" else "train_bf16"
        assert extra["row_errors"][0] == f"{row}: RuntimeError: {failing} broke"
        assert extra.get("headline_missing", False) == (failing == "bench_train")


def _card_extra():
    """A card run's extra keys in main's order, at full-width values."""
    extra = {"card": "NVIDIA H100 80GB HBM3, 700.00 W",
             "train_int8_binary_eps": 227_512.3, "headline_device_busy_ms": 1.0041812345678,
             "headline_idle_share": 0.8712345678901, "headline_launch_check": "matched",
             "train_int8_binary_eager_eps": 253_595.6,
             "headline_eager_device_busy_ms": 0.7643212345678,
             "train_bf16_kernel_eps": 201_234.5, "cpu_f32_eps": 5_123.4,
             "train_coo_50kx30k_eps": 18_708.8, "train_densebf16_50kx30k_eps": 17_625.1,
             "diffusion_tall_factored_s": 0.01234, "diffusion_tall_blocked_s": 0.41234,
             "retrieval_qps": 8_234_567.1, "retrieval_qps_steady": 9_234_567.1,
             "retrieval_qps_k100": 7_234_567.1, "retrieval_qps_k100_steady": 8_234_567.1}
    for tag in ("retrieval_stream_50k", "retrieval_stream_50k_k1000"):
        extra.update({f"{tag}_qps": 274_321.9, f"{tag}_xla_qps": 172_654.3,
                      f"{tag}_agree": 0.999912})
    extra.update({"serve_fused_qps": 2_912_345.6, "serve_fused_qps_steady": 3_312_345.6,
                  "serve_fused_qps_k100": 2_712_345.6, "serve_fused_qps_k100_steady": 3_112_345.6,
                  "lambda_sweep_101pts_s": 0.4123, "kernel_contracts": "pass"})
    return extra


def test_format_record_keeps_every_key_of_a_card_line(tiny, tmp_path):
    extra = _card_extra()
    keys = list(extra)
    line = bench_torch.format_record(227_512.3, 44.41, "synthetic-ml1m-scale", extra,
                                     out_dir=str(tmp_path))
    assert len(line) <= 1500
    assert list(json.loads(line)["extra"]) == keys + ["stats_file"]


def test_format_record_budget_and_contract(tiny, tmp_path):
    (tmp_path / "j").mkdir()
    j_line = bench.format_record(1000.0, 2.0, "synthetic", {}, out_dir=str(tmp_path / "j"))
    port_dir = tmp_path / "port"
    extra = {f"metric_{i}": 123456.7 for i in range(40)}
    extra["kernel_contracts"] = [f"check_{i}: " + '"\\' * 60 for i in range(8)]
    extra["row_errors"] = [f"row_{i}: " + '"\\' * 60 for i in range(12)]
    line = bench_torch.format_record(1000.0, 2.0, "synthetic", extra, out_dir=str(port_dir))
    assert len(line) <= 1500
    rec = json.loads(line)
    assert set(rec) == set(json.loads(j_line))
    assert rec["extra"]["stats_file"] == bench_torch.STATS_FILE
    assert "rows failed" in rec["extra"]["row_errors"]
    side = json.loads((port_dir / bench_torch.STATS_FILE).read_text())
    assert len(side["record"]["extra"]["row_errors"]) == 12
    assert sorted(os.listdir(port_dir)) == [bench_torch.STATS_FILE]


def test_imports_no_jax_no_jax_package_no_top_level_pandas():
    path = os.path.join(os.path.dirname(bench_torch.__file__), "bench_torch.py")
    tree = ast.parse(open(path).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "lgcnhs_tpu", "bench", "optax"}, roots
    assert "lgcnhs_tpu_torch" in roots and "torch" in roots
    top = {a.name.split(".")[0] for node in tree.body if isinstance(node, ast.Import)
           for a in node.names}
    top |= {(node.module or "").split(".")[0] for node in tree.body
            if isinstance(node, ast.ImportFrom)}
    assert "pandas" not in top and "pandas" in roots


def test_main_gives_the_package_logger_its_level_back(tiny, tmp_path, capsys):
    """``main`` quiets the dispatch's per-call INFO lines while it runs and
    restores the ``lgcnhs`` logger's level after."""
    import logging

    logger = logging.getLogger("lgcnhs")
    level = logger.level
    bench_torch.main(["--device", "cpu", "--out-dir", str(tmp_path)])
    assert logger.level == level

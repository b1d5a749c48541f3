#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA port (``lgcnhs_tpu_torch``): the quickest
proof that the port builds, trains and serves on an NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository beside this file; imports
neither JAX nor ``lgcnhs_tpu``. Phases:

1. Environment: the card's name and power limit.
2. Build: every CUDA source of the port, all nvcc processes at once.
3. Kernels against their plain twins (the checks of ``tests/tpu_smoke.py``
   on the card): identical indices and values on inputs whose scores are
   exact in f32, tie-equivalence (agreement >= 0.98, mismatched slots within
   5e-4 relative under an f64 reference) on continuous inputs. Retrieval
   (one kernel in place of both Pallas kernels) at k=1/100/1000 at the
   ML-100K (943 x 1682) and ML-1M (6040 x 3706) shapes, at k=10/100 at
   384 x 896, at k=100/1000 over 50k items and at D=1024, and at
   k=1/128/129/407/408/1000/3000 over catalogs off its 128-item steps (the
   edges of its in-register merges and of its lists in shared memory;
   running and merge lists in device memory), with sub-sentinel users and
   a second launch bitwise equal to the first. Fused serving
   with a fewer-than-k-unseen user and a user with no interactions (a
   second launch bitwise equal), at the slice's 6040 x 3706 x 64 too, also
   over 20,000 items (past the earlier kernel's shared-memory cap) at
   k=1/100/1000, with a W of 20 significant bits (which every bf16 part of
   W must carry), and ragged shapes (partial user blocks, k == I, I below a
   warp, k above 128, an A that is not exact in bf16). Each kernel's block
   memory against its Python sizing (and the retrieval kernel's blocks an
   SM as its launcher reports them), the retrieval route,
   the fused serving kernel's bf16 split of A and W against the plain
   split and its flag for an A not exact in bf16. ``dual_matmul``
   (training) for its four
   dtype pairs on the slice's 6040 x 3706 train incidence at D=64, forward
   and backward: bitwise equal on dyadic inputs, within 1e-5 of each
   output's scale on continuous ones (f32 sums in another order; a bf16
   gradient also within one bf16 rounding), two launches bitwise equal;
   and on ragged shapes (U, I off the tiles and off 16, I below a warp,
   D 3/8/20/64/128, a skewed incidence); its shared-memory guard against
   the launcher's own figure.
4. The serving slice end to end through ``lgcnhs_tpu_torch.cli.retrieve``
   (``--env prod``, k=100) with seeded LightGCNOpti checkpoints:
   SpreadLightGCNOpti (fused serving) and LightGCNOpti (fused retrieval)
   at ML-1M scale and over a 49,410-item catalog, and LightGCNOpti over
   that catalog at k=1000 (running lists in device memory). Float64
   checkpoints at ML-1M for both models: served at f64 on the card by the
   plain chain, no kernel launched, identical to that chain run directly
   and to it on the CPU (tie-equivalent for fused serving, whose f32
   product F sums in another order there). Then the training slice: the
   same CLI on an empty workdir trains LightGCNOpti for 1000 epochs through
   the ``dual_matmul`` kernel (6 launches a step) and serves
   SpreadLightGCNOpti from the checkpoint it wrote. Launch counts (and the
   counts of the second kernels: the split-K sum of ``dual_matmul``, the
   catalog parts' merges) are zeroed just before each path and read just
   after, and each run is checked to have gone through its kernel alone.
   Every output is checked against the plain chain, the training history for finite values and a
   falling loss. Last, 20 epochs on the kernel route and on the twin route
   from one seed, compared within the stated tolerance.
   The main path, ``lgcnhs_tpu_torch.cli.main``, after the cli/retrieve
   runs: all seven models at ML-1M on seeded random checkpoints (a
   LightGCN-shaped one for LightGCN and SpreadLightGCN), LightGCNOpti and
   SpreadLightGCNOpti over the 49,410-item catalog, and both on the
   trained checkpoint (loaded, not trained again; R@100 above the random
   tables'). Launch counts are set to 0 before each run and read after:
   exactly one ``fused_topk_retrieval`` for LightGCN[Opti], none of any
   kernel for the other five (no serving kernel, no training). Each list is
   held against the same recommendation computed on the CPU (identical, or
   tie-equivalent under f64 scores computed on the card), and the metric
   dict against the card's list evaluated on the CPU (equal, or an
   unrounded value within 1e-5 relative across a 5-decimal boundary).
5. Timings at the main path's shapes: kernel, plain twin, and the nearest
   library composition (torch.matmul + torch.topk, two bf16 torch.matmul
   for ``dual_matmul``; no single PyTorch call computes these functions, so
   ``library_ms`` is null), medians of CUDA-event timings; every kernel's
   device ms and its composition's from ``torch.profiler`` and its share of
   the bound (fused serving: also its dense floor, the tensor-core work of
   its design at the bf16 peak); retrieval also over the 49,410-item
   catalog at k=100 and k=1000; the train step's ms and examples/s over a
   synchronized steady window, its device-busy ms and idle share, and its
   device time by kernel from ``torch.profiler``. ``cli/main``'s host
   seconds per run, split into Step 2 (recommend) and Step 3 (evaluate),
   its peak device memory, and the host ms of each device stage of
   SpreadLightGCNOpti's (diffusion, G, G * F, ranking, evaluation) at
   ML-1M and over 49,410 items.
6. Large graphs on one card (``large_graph_phase``), at the JAX bench's
   large-graph scale (50,000 x 30,000 synthetic, ~2M train edges, the prod
   preset): (a) 300 epochs through ``dual_matmul`` with two CSR
   evaluations (one retrieval launch a user chunk), then ``cli/main
   --model LightGCNOpti`` on that checkpoint (``recommend_gcn``'s chunked
   branch, each chunk's ids held against the plain chain on the card);
   ``dual_matmul`` and a chunk's retrieval at these shapes against their
   twins (and ``dual_matmul`` against the exact f64 sums), timed; (b) 40
   epochs at ``compute.dtype=float32``, the COO (bucketed-ELL) route; (c)
   the bf16-dense rung (``compute.use_pallas=false``) beside the kernel
   route over 20 epochs, within the JAX rung test's tolerance; the ML-1M
   stand-in forced into COO beside its dense f32 route, one seed. Launch
   counts set to 0 before each run and read after; each run's seconds, ms
   a step, CSR-evaluation retrieval and I@k seconds and peak memory. Then
   ``dual_matmul``'s gap to the exact (f64) sums against the sum length
   (``dual_accumulation_check``): a dense int8 R of ones, bf16-exact X and
   Y of mixed and of positive signs, sums of 3,706 to 100,000 products in
   each role, within ``ACCUM_REL_TOL`` of scale, the plain twin beside it.
7. The single-device entry points (``lambda_resume_report_phase``), run
   right after phase 4 on its workdirs, every launch count set to 0 before
   each run and read after: (a) ``cli/find_lambda`` at ML-1M over the full 101-point grid on
   the checkpoint phase 4 trained (loaded, not trained; no kernel
   launched), its rows at lambda 0, 0.5, the preset's 0.6 and 1 held
   against ``fused_recommend`` plus the evaluation on the card (the lists
   identical or tie-equivalent, the metrics by phase 4's rule) and against
   the same sweep on the CPU; (b) the W-free flavor over the 49,410-item
   catalog at ``--step 0.25`` (5 points; every function that builds an
   (I, I) operand made to raise), lambda 0.5 held as in (a); (c) resume on
   the ``dual_matmul`` route at ML-1M, one seed: 40 epochs uninterrupted,
   then 21 with a checkpoint every 20 and a resume to 40, 240 launches in
   each, the restored state bitwise the saved one, tables within 1e-3 and
   history within 1e-4 of the uninterrupted run; (d) ``cli/evaluate`` over
   phase 4's cached lists of the seven models at k=100, each metric dict
   equal to phase 4's ``cli/main`` line, the workbook a zip with one sheet,
   then ``cli/ablation`` on its CSV (a chart where matplotlib imports).
   Each run's host seconds and peak device memory, the sweep's seconds a
   grid point split into diffusion, ranking and metrics, the resume's save
   and restore ms. Phase 5 also times fused serving over the 49,410-item
   catalog beside matmul+topk on the same inputs.
8. Raw-data ingestion (``ingestion_phase``, after phase 6), on seeded
   directories in each distribution's file schema
   (``lgcnhs_tpu_torch/data/raw_standins.py``):
   (a) ML-100K at its size (943 x 1682, 100,000 ratings; latin-1 titles,
   missing dates, quoted titles): the native graph builder built and its
   parse equal to the reader's; ingestion on the card against the same code
   on the CPU (splits, id mappings and the non-text feature columns
   identical, the text columns trained); word2vec on the card within
   ``W2V_ATOL`` of the CPU under one injected negative stream, two card runs
   with the card's own draws bitwise equal; ``cli/main --data-dir --env prod
   --epochs 300`` for LightGCNOpti (trains through ``dual_matmul``,
   recommends through ``fused_topk_retrieval``; ``--target-user`` by raw id)
   and SpreadLightGCNOpti, then ``cli/retrieve --decode`` for
   SpreadLightGCNOpti (``fused_lgcnhs_serve``; its raw-id JSON checked);
   (b) phase 4's ML-1M stand-in written as ``.dat`` files: ingested (the
   native parser used) with splits identical to the synthetic tier's, then
   ``cli/main`` LightGCNOpti; (c) Douban (``DOUBAN_SIZE``, the preset's
   quantile band; storylines that train word2vec thousands of steps):
   ingested, word2vec checked as in (a), ``cli/main`` LightGCNOpti. Launch
   counts set to 0 before each run and read after; every list held against
   the CPU run (identical or tie-equivalent) and its metrics by phase 4's
   rule. Host seconds of each ingestion part (parse, ratings, features,
   word2vec with its steps and ms a step on the card), each ``cli/main``
   run's Step 1-3 seconds and peak device memory.

9. The mesh (``mesh_phase``): a world-1 NCCL process group from a
   file store and ``make_mesh((1, 1))`` (the card machine has one card:
   NCCL takes no two ranks on one GPU, so the mesh runs at world size 1
   here and no scaling is measured). At the prod preset, D=64, k=100, each
   beside its single-device route: (a) ``train_lightgcn_on_mesh`` against
   ``train_lightgcn`` on the ``dual_matmul`` route at ML-1M, 20 epochs from
   one seed (history within ``TWIN_LOSS_TOL``, tables within
   ``TWIN_TABLE_TOL``, 6 launches a step and nothing else), and the train
   step alone, the two routes in turns; (b) ``distributed_retrieve_topk``
   at ML-1M and over the 49,410-item catalog at k=100 and k=1000: ids
   identical to ``retrieve_topk``, one ``fused_topk_retrieval`` launch a
   call; (c) ``distributed_fused_recommend`` against ``fused_recommend``
   (identical or tie-equivalent under f64 scores); (d)
   ``sharded_diffusion_scores`` within ``MESH_DIFF_TOL`` of
   ``diffusion_scores``; (e) ``sharded_lambda_sweep`` in both layouts
   (grid-parallel, item-sharded with W_gen and S built as collective Grams)
   over ``MESH_SWEEP_POINTS`` points: rows equal ``lambda_sweep_metrics``'.
   Launch counts set to 0 before each run and read after; each row's mesh
   and single-device ms (the collectives' cost at world size 1). Phase 5
   also times matmul+topk at k=1000 over the 49,410 items beside the
   retrieval kernel.
10. The mesh's large-graph half (``mesh_large_phase``, last): a world-1
   NCCL group again and ``make_mesh((1, 1))``, on phase 6's large graph
   (49,933 x 30,000) at the prod preset, D=64, k=100 (cut from the
   multi-GPU meshes it serves to the one card, nothing else): (a)
   ``train_lightgcn_on_mesh`` against ``train_lightgcn``'s COO route, 20
   f32 epochs from one seed with one CSR evaluation (the graph takes COO
   on a mesh by itself at the prod preset, asserted; history within
   ``TWIN_LOSS_TOL``, tables within ``TWIN_TABLE_TOL``; no ``dual_matmul``,
   one retrieval launch a user chunk at the distributed CSR site, counted
   apart as ``DISTRIBUTED``); (b) one ``make_sharded_coo_train_step``
   step in the bucketed and the segment layout on the same triples,
   within ``LAYOUT_REL_TOL`` of scale, then both layouts' and the
   single-device COO step's ms a step, in turns; (c) the table-sharded
   plan against (a)'s replicated one, history within
   ``TABLE_SHARDED_HISTORY_TOL``; (d) ``make_distributed_csr_masked_topk``
   against ``chunked_masked_topk`` at k=100 (ids identical, one launch a
   chunk, both timed), and the kernel at this site's chunk against its
   twin; (e) resume (8 epochs with a checkpoint at 7, on to 14, against
   14) on the mesh COO route, the single-device COO route and the
   bf16-dense rung, tables within ``RESUME_TABLE_TOL`` (these runs'
   evaluations skip I@k, a host Gram that writes no table); (f)
   ``cli/scaling --meshes 1``, dense and ``--coo``: one row each,
   efficiency 1.0 (each rung its own NCCL process group). Launch counts
   set to 0 before each run and read after; each row's mesh and
   single-device ms, the CSR evaluation's retrieval and I@k seconds.
11. The last modules (``experimental_phase``, after phase 10; a 30 s
   budget, its time printed): (a) the experimental autoencoders
   (``models/experimental.py``) on the ML-100K stand-in (943 x 1684, its own
   user and item features, a joint adjacency of 2627^2) through
   ``load_pipeline``: ``train_autoencoder`` for ``gcn`` and ``gat``,
   ``AE_EPOCHS`` epochs each on the card and on the CPU from one injected
   init, the history within ``AE_HISTORY_RTOL`` relative at every epoch,
   the parameters within ``AE_PARAM_TOL`` of scale, each kind's ms an
   epoch on both and its own peak device memory (above what the
   earlier phases hold); ``hybrid_gat_fusion`` on the
   card's GAT parameters, its top-100 lists on the card tie-equivalent to
   the CPU's under the f64 fused scores; then, in a fresh process as a user
   runs them (``cli_child``), (b) ``cli/main --model LightGCNOpti
   --profile DIR`` on phase 4's trained ML-1M checkpoint between two runs
   without it: the metric line equal to theirs, one
   ``fused_topk_retrieval`` launch in each, one trace file holding a CUDA
   kernel event of ``fused_topk_kernel`` (CUPTI sees the ctypes launches),
   the trace's overhead in host seconds, and (c) ``cli/parity_report`` on
   the card: ``{"reference": false}`` (no reference checkout there) and
   exit 0. (b) runs in a fresh process because late in this long process
   the profiler has lost card records (``tools/profile_probe.py`` probes
   that; PERF.md). Launch counts set to 0 before each run and read after:
   no hand kernel runs in (a).
12. The port's bench (``bench_phase``, last; a 150 s budget, its time
   printed): ``python3 bench_torch.py --out-dir DIR`` in a fresh process
   (its profiler session is that process's first), with a timeout. Its
   last line parses, its metric is ``lightgcn_train_examples_per_sec_ml1m``
   with a value above 0, its ``kernel_contracts`` is "pass" (every kernel
   held against its twin at its bench row's shapes), it has no
   ``row_errors``, the headline's trace matched the ``dual_matmul``
   launches, and each kernel was launched by the bench (its side file's
   counts, set to 0 at its start). The line, each row's seconds and peak
   memory, and the CPU baseline's seconds are printed.

Prints one PASS/FAIL line per check, then (all passed) the kernel JSON line,
the ``nvidia-smi`` name/power-limit line, and the final
``{"ok": true, "device": ...}`` line. Any failure exits non-zero and prints
no result.
"""
from __future__ import annotations

import csv
import itertools
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

SEED = 0
K_SLICE = 100
K_LARGE = 1000  # a long list over the large catalog: running lists in device memory
BIG_CATALOG = 50_000  # tests/tpu_smoke.py's streaming size (49,410 items kept)
AGREEMENT_MIN = 0.98
GAP_MAX = 5e-4
# NVIDIA H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s, f32 FLOP/s
# outside the tensor cores (every kernel here is full f32)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12  # dense tensor-core rate, dual_matmul's operand type
TRAIN_EPOCHS = 1000
TWIN_EPOCHS = 20
DUAL_REL_TOL = 1e-5
BF16_ULP = 2.0 ** -7  # bf16 spacing: at most 2^-7 of a value
# Kernel route vs twin route over TWIN_EPOCHS (phase 4). Their f32 sums
# differ in order, so a bf16 cast between layers can round one step apart
# (2^-8 relative on an element); that can flip a small gradient's sign, and
# Adam then moves the element up to ~2 lr a step apart (0.04 over 20 steps
# at lr 1e-3). Measured: table gaps 1.9e-5 and 8.7e-6 at table scale 3.0,
# losses equal to 5 decimals (PERF.md). The tolerances sit 50x above
# the measured gaps, far below the worst case.
TWIN_LOSS_TOL = 1e-4
TWIN_TABLE_TOL = 1e-3
# phase 6, the large graphs: the JAX bench's 50k x 30k scale (bench.py:346-372)
LARGE_USERS, LARGE_ITEMS, LARGE_INTERACTIONS = 50_000, 30_000, 2_900_000
LARGE_EPOCHS, LARGE_EVAL_EVERY = 300, 150  # run (a): two CSR evals
COO_EPOCHS = 40  # run (b)
SHORT_EPOCHS = 20  # run (c), the rung beside the kernel route
# the rung against the kernel route: the JAX rung test's tolerance
# (tests/test_propagation_paths.py:57-95); only the incidence rounding differs
RUNG_RTOL, RUNG_ATOL = 0.05, 5e-3
# the COO route against the dense f32 route at ML-1M over TWIN_EPOCHS: the
# same triples, f32 sums in another order (index_add_ in no fixed order on
# the card)
COO_LOSS_TOL = 1e-5
COO_TABLE_TOL = 1e-4
# dual_matmul on the large graph against its exact products (f64): a hub
# item's output sums tens of thousands of bf16 products in f32, several
# times ML-1M's longest sum, so DUAL_REL_TOL does not carry over. Measured:
# the kernel 1.058e-6 of scale from the exact sums with its two-level sum
# (3.469e-5 when the mma accumulators held the whole depth), the twin's f32
# matmul 1.3e-7; a misplaced tile is O(1). The bar sits between the two
# sums' readings, so the whole-depth sum fails it.
LARGE_DUAL_REL_TOL = 1e-5
# phase 7 (c): resume on the dual_matmul route at ML-1M. The card sums the
# backward of the table gathers with atomics, in no fixed order, so two runs
# of the same route are not bitwise equal; the bar is the kernel-vs-twin
# one above (tables 1e-3, history 1e-4), 50x the gaps measured there.
RESUME_EPOCHS, RESUME_STOP, RESUME_EVERY, RESUME_EVAL_EVERY = 40, 21, 20, 10
RESUME_TABLE_TOL = 1e-3
RESUME_HISTORY_TOL = 1e-4
# phase 8, raw-data ingestion: cli/main trains LightGCNOpti this many prod
# epochs on each ingested dataset
INGEST_EPOCHS = 300
# word2vec on the card against the CPU under one injected negative stream:
# f32 sums in another order, the CPU tests' tolerance against JAX (1.8e-6
# measured there at dim 20; 3e-7 to 7e-7 on an H100 over this phase's corpora)
W2V_ATOL = 1e-5
# phase 6: dual_matmul's gap to the exact (f64) sums against the sum length,
# a dense int8 R of ones and bf16-exact X and Y (every product exact in f32)
ACCUM_LENGTHS = (3706, 10_000, 30_000, 100_000)
ACCUM_WIDE = 128  # the other side of R
# The f32 matmul sits within 4e-7 of scale at every length; the kernel's
# two-level sum within 1.8e-6 at 100,000 positive products; summed in the
# mma accumulators across the whole depth it sat 1.5e-4 below, all of one
# sign (tools/dual_accum.py, PERF.md).
ACCUM_REL_TOL = 1e-5
# phase 9, the mesh on NCCL at world size 1: training from one seed on the
# mesh route and the single-device kernel route over TWIN_EPOCHS (the same
# products, the collectives between them), held to the kernel-vs-twin bars;
# the sharded diffusion within 1e-5 of each output's scale; the sweep over
# MESH_SWEEP_POINTS grid points, its rows equal and its raw metrics within
# 1e-5 relative (tests/test_sweep.py's bar)
MESH_SWEEP_POINTS = 5
MESH_DIFF_TOL = 1e-5
MESH_SWEEP_RTOL = 1e-5
# the retrieval kernel's launches inside ops/scalable.chunked_masked_topk,
# counted apart from its other launches (phases 6 and 8)
CHUNKED = "fused_topk_retrieval@chunked_masked_topk"
# phase 10, the mesh on the large graph: the retrieval kernel's launches made
# by the mesh's CSR evaluation (parallel/sharding.make_distributed_csr_masked_topk),
# counted apart from the other two sites
DISTRIBUTED = "fused_topk_retrieval@distributed_csr_masked_topk"
# (a) and (c) train TWIN_EPOCHS with one CSR evaluation; (b) one step of each
# layout on the same triples: the same sums in another grouping, within
# LAYOUT_REL_TOL of scale; (c) the table-sharded plan against the replicated
# one within the dry run's 2e-5 (__graft_entry__.py:152-161); (e) resume,
# RESUME_STOP_10 epochs with a checkpoint at RESUME_EVERY_10, then on to
# RESUME_EPOCHS_10, within RESUME_TABLE_TOL of one run
LAYOUT_REL_TOL = 1e-5
TABLE_SHARDED_HISTORY_TOL = 2e-5
RESUME_EPOCHS_10, RESUME_STOP_10, RESUME_EVERY_10 = 14, 8, 7
# phase 11, the experimental autoencoders at ML-100K: 100 full-batch epochs
# of each kind at the JAX default width, the card against the CPU from one
# init (f32 sums in another order: the tolerances of the kernel-vs-twin
# route, TWIN_LOSS_TOL and TWIN_TABLE_TOL, relative here), and
# hybrid_gat_fusion at the JAX test's lambda
AE_EPOCHS, AE_HIDDEN, AE_LAMBDA = 100, 64, 0.5
AE_HISTORY_RTOL, AE_PARAM_TOL = 1e-4, 1e-3
# phase 12, bench_torch.py in its own process: the budget (printed) and the
# timeout that stops it
BENCH_BUDGET_S, BENCH_TIMEOUT_S = 150, 450
W2V_STORY_DOCS = 300  # the CPU side of the storyline check trains on these
# Douban: 160,000 users at 6.5 ratings each, the ratio of the public dump
# (~4.2 M ratings by ~640,000 users); the preset keeps the users whose rating
# counts lie between the counts' 0.99 and 0.991 quantiles, a few hundred here.
# Storylines of 80 words over 2000 movies and the nicknames give word2vec
# ~7000 steps.
DOUBAN_SIZE = {"n_users": 160_000, "n_movies": 2_000, "n_ratings": 1_040_000,
               "story_words": 80}


class Checks:
    def __init__(self):
        self.failures = []

    def __call__(self, name, ok, detail=""):
        print(f"[{'PASS' if ok else 'FAIL'}] {name}" + (f" -- {detail}" if detail else ""),
              flush=True)
        if not ok:
            self.failures.append(name)
        return ok

    def guard(self, name, fn, *args):
        """Runs one check group; an exception fails it and is printed."""
        try:
            return fn(*args)
        except Exception:  # a failed phase is reported, the others still run
            traceback.print_exc()
            self(name, False, "raised")
            return None


def tie_equivalence(torch, want_idx, got_idx, ref):
    """(agreement, max relative gap over mismatched slots under ``ref``)."""
    want, got = want_idx.long(), got_idx.long()
    mism = want != got
    agreement = 1.0 - mism.double().mean().item()
    if not bool(mism.any()):
        return agreement, 0.0
    w, g = ref.gather(1, want)[mism], ref.gather(1, got)[mism]
    gap = ((w - g).abs() / (torch.maximum(w.abs(), g.abs()) + 1e-5)).max().item()
    return agreement, gap


def compare(torch, check, name, got, want, ref=None):
    """Exact (ref None): identical indices and values. Else tie-equivalence."""
    gi, gv = got
    wi, wv = want
    if ref is None:
        same_i, same_v = torch.equal(gi, wi), torch.equal(gv, wv)
        return check(name + " == twin (exact)", same_i and same_v,
                     f"{int((gi != wi).sum())} index and {int((gv != wv).sum())} value "
                     "mismatches")
    agreement, gap = tie_equivalence(torch, wi, gi, ref)
    return check(name + " tie-equivalent to twin",
                 agreement >= AGREEMENT_MIN and gap <= GAP_MAX,
                 f"agreement {agreement:.6f}, mismatched-slot max relative gap {gap:.3e}")


def gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def metrics_disagree(card, card_un, cpu_un):
    """Keys where the card's rounded dict departs from the CPU's values: a
    rounded value must equal the CPU's, or the two unrounded values lie
    within 1e-5 relative on two sides of a 5-decimal boundary; F1 (from
    the rounded P and R) must equal the CPU's where P and R do."""
    bad = [key for key, v in cpu_un.items()
           if card[key] != round(v, 5)
           and not (card[key] == round(card_un[key], 5)
                    and abs(card_un[key] - v) <= 1e-5 * abs(v))]
    p, r = round(cpu_un["P"], 5), round(cpu_un["R"], 5)
    f1 = 0.0 if p + r == 0 else round(2 * p * r / (p + r), 5)
    if (card["P"], card["R"]) == (p, r) and card["F1"] != f1:
        bad.append("F1")
    return bad


def unrounded(ctx, rec, direct):
    """P, R, NDCG, H, I of ``rec`` before rounding; ``direct``: I without the
    (I, I) similarity matrix (``internal_similarity_direct``)."""
    from lgcnhs_tpu_torch.eval import metrics as tev
    from lgcnhs_tpu_torch.ops import metrics_ops

    p, r, n = tev.accuracy_unrounded(ctx, rec)
    if direct:
        rec_t = ctx.on_device(rec)
        h = float(metrics_ops.hamming_distance(rec_t, ctx.n_items))
        i = float(metrics_ops.internal_similarity_direct(
            rec_t, ctx.on_device(ctx.interaction), ctx.on_device(ctx.item_deg)))
    else:
        h, i = tev.diversity_unrounded(ctx, rec)
    return {"P": p, "R": r, "NDCG": n, "H": h, "I": i}


def median_ms(torch, fn, reps, warmup=1):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound(nbytes, flops, peak_flops=PEAK_F32_FLOP_PER_S):
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


class StepClock(logging.Handler):
    """Host clock of cli/main's log lines: Step 2 (recommend) runs from its
    line to Step 3's, Step 3 (evaluate) to the metric line."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.marks = {}

    def emit(self, record):
        msg = record.getMessage()
        for mark, found in (("step2", msg.startswith("Step2:")),
                            ("step3", msg.startswith("Step3:")),
                            ("end", "Test Accurate]" in msg)):
            if found:
                self.marks[mark] = record.created


class TrainProbe:
    """Times a ``train_lightgcn`` run from the inside while it is active:
    the train step over the steady window of epochs ``first``..``last``
    (no eval inside it; the card synchronized at its two ends), and each
    CSR eval's chunked retrieval and I@k (host seconds, the card
    synchronized around each call). It wraps the trainer module's names
    and restores them on exit."""

    NAMES = ("make_train_step", "make_coo_train_step", "chunked_masked_topk",
             "internal_similarity_csr")

    def __init__(self, torch, trainer, first, last):
        self.torch, self.trainer = torch, trainer
        self.first, self.last = first, last
        self.step_ms = None
        self.topk_s, self.iak_s = [], []

    def _factory(self, factory):
        def make(*a, **kw):
            step = factory(*a, **kw)

            def timed(params, epoch, *rest):
                if epoch == self.first:
                    self.torch.cuda.synchronize()
                    self.t0 = time.perf_counter()
                loss = step(params, epoch, *rest)
                if epoch == self.last:
                    self.torch.cuda.synchronize()
                    self.step_ms = ((time.perf_counter() - self.t0) * 1e3
                                    / (self.last - self.first + 1))
                return loss

            return timed

        return make

    def _call(self, fn, into):
        def call(*a, **kw):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out

        return call

    def __enter__(self):
        self.saved = {name: getattr(self.trainer, name) for name in self.NAMES}
        t = self.trainer
        t.make_train_step = self._factory(self.saved["make_train_step"])
        t.make_coo_train_step = self._factory(self.saved["make_coo_train_step"])
        t.chunked_masked_topk = self._call(self.saved["chunked_masked_topk"], self.topk_s)
        t.internal_similarity_csr = self._call(self.saved["internal_similarity_csr"],
                                               self.iak_s)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.trainer, name, fn)
        return False


def large_graph_phase(check, dev, smi, clock):
    """Phase 6: the large-graph paths at the JAX bench's large-graph scale
    (``bench.py:284-403``): ``--dataset synthetic --users 50000 --items
    30000 --interactions 2900000``, D=64, k=100, batch 1024, the prod preset.
    Returns the measurements the kernel report takes."""
    import numpy as np
    import torch

    from lgcnhs_tpu_torch import config as tcfg
    from lgcnhs_tpu_torch.cli import main as cli_main
    from lgcnhs_tpu_torch.data.datasets import load_dataset
    from lgcnhs_tpu_torch.data.graph import EdgeSet, build_graph, unique_edges
    from lgcnhs_tpu_torch.ops import scalable
    from lgcnhs_tpu_torch.ops.cuda import fusion_serve as fs
    from lgcnhs_tpu_torch.ops.cuda import propagation as prop
    from lgcnhs_tpu_torch.ops.cuda import retrieval as rt
    from lgcnhs_tpu_torch.ops.topk import MASK_VALUE, masked_topk
    from lgcnhs_tpu_torch.train import trainer

    kernels = {"dual_matmul": prop.dual_matmul, "fused_topk_retrieval": rt.fused_topk_retrieval,
               "fused_lgcnhs_serve": fs.fused_lgcnhs_serve}
    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_large_", dir=os.path.join(ROOT, "artifacts"))
    sizes = {"synthetic_users": LARGE_USERS, "synthetic_items": LARGE_ITEMS,
             "synthetic_interactions": LARGE_INTERACTIONS}
    big_args = ["--dataset", "synthetic", "--env", "prod", "--users", str(LARGE_USERS),
                "--items", str(LARGE_ITEMS), "--interactions", str(LARGE_INTERACTIONS)]
    out = {"runs": []}

    def cfg_for(dataset="synthetic", **over):
        return tcfg.load_config(env="prod", dataset=dataset, model="LightGCNOpti", workdir=work,
                                overrides={**(sizes if dataset == "synthetic" else {}), **over})

    t0 = time.perf_counter()
    splits, uf, itf = load_dataset(cfg_for())
    g = build_graph(splits)
    U, I, E = g.n_users, g.n_items, g.train.n_edges
    data_s = time.perf_counter() - t0
    deg_i = np.bincount(unique_edges(g.train).items, minlength=I)
    print(f"[phase 6] large graph: {U} x {I}, {E} train edges (density {E / (U * I):.6f}), "
          f"{g.val.n_edges} val; item degrees up to {deg_i.max()} (p99 "
          f"{np.percentile(deg_i, 99):.1f}); data on the host in {data_s:.2f} s", flush=True)
    n_chunks = -(-U // scalable.chunk_users(U, I, 1))  # the kernel route's chunks

    def run(label, cfg, graph, feats, first, last, want, save=False):
        """One train_lightgcn on the card: launch counts set to 0 just
        before and read just after, checked against ``want``; its step ms,
        CSR eval seconds and peak device memory."""
        for fn in kernels.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with TrainProbe(torch, trainer, first, last) as probe:
            result = trainer.train_lightgcn(graph, cfg, *feats, save_artifacts=save,
                                            device=dev)
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counted = {name: fn.launches for name, fn in kernels.items()}
        row = {"run": label, "route": want["route"], "seconds": secs, "step_ms": probe.step_ms,
               "examples_per_s": cfg.hparams.batch_size / probe.step_ms * 1e3,
               "csr_eval_topk_s": probe.topk_s, "iak_s": probe.iak_s,
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counted}
        out["runs"].append(row)
        hist = result.history
        print(f"[phase 6] {label}, {want['route']}: {secs:.2f} s, {probe.step_ms:.4f} ms/step "
              f"({row['examples_per_s']:.1f} examples/s), CSR eval retrieval s {probe.topk_s}, "
              f"I@k s {probe.iak_s}, peak device {row['peak_device_gb']:.2f} GB, launches "
              f"{counted}; history {json.dumps(hist)} [{smi}]", flush=True)
        wanted = {name: want.get(name, 0) for name in kernels}
        check(f"large graph {label}, {want['route']}: launches {wanted}", counted == wanted,
              f"{counted}")
        check(f"large graph {label}: history finite, evals at {want['iters']}",
              hist["iters"] == want["iters"]
              and all(math.isfinite(v) for col in hist.values() for v in col), f"{hist}")
        return result

    # (a) the prod preset: the kernel route (int8 R through dual_matmul) with
    # the CSR evaluation, every chunk one retrieval launch
    evals_a = list(range(0, LARGE_EPOCHS, LARGE_EVAL_EVERY))
    cfg_a = cfg_for(**{"hparams.epochs": LARGE_EPOCHS, "hparams.epoch_per_eval": LARGE_EVAL_EVERY})
    check("large graph: the prod preset takes the dense side (bf16), float32 the COO side",
          trainer.choose_propagation(U, I, E, cfg_a.compute) == "dense"
          and trainer.choose_propagation(U, I, E, cfg_for(**{"compute.dtype": "float32"}).compute)
          == "coo" and 4.0 * U * I > trainer.DENSIFY_BUDGET_BYTES)
    res_a = run("(a)", cfg_a, g, (uf, itf), 1, LARGE_EVAL_EVERY - 1,
                {"route": "kernel route + CSR eval", "iters": evals_a,
                 "dual_matmul": 6 * LARGE_EPOCHS,
                 "fused_topk_retrieval": len(evals_a) * n_chunks}, save=True)
    out["dual_launches"] = out["runs"][-1]["launches"]["dual_matmul"]
    out["chunk_launches"] = out["runs"][-1]["launches"]["fused_topk_retrieval"]
    hist = res_a.history
    check("large graph (a): train loss falls", hist["train_loss"][-1] < hist["train_loss"][0],
          f"{hist['train_loss']}")

    # cli/main on (a)'s checkpoint: loaded, recommend_gcn's chunked branch
    for fn in kernels.values():
        fn.launches = 0
    clock.marks.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics = cli_main.main(["--device", dev.type, "--workdir", work, "--model", "LightGCNOpti",
                             *big_args])
    host_s = time.perf_counter() - t0
    counted = {name: fn.launches for name, fn in kernels.items()}
    marks = clock.marks
    main_row = {"run": "cli/main LightGCNOpti, (a)'s checkpoint", "host_s": host_s,
                "step2_s": marks["step3"] - marks["step2"],
                "step3_s": marks["end"] - marks["step3"],
                "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counted}
    out["main_row"] = main_row
    out["chunk_launches"] += counted["fused_topk_retrieval"]
    print(f"[phase 6] cli/main LightGCNOpti {U}x{I}: {json.dumps(metrics)} in {host_s:.2f} s "
          f"(Step 2 recommend {main_row['step2_s']:.4f} s, Step 3 evaluate "
          f"{main_row['step3_s']:.4f} s), peak device {main_row['peak_device_gb']:.2f} GB, "
          f"launches {counted} [{smi}]", flush=True)
    want = {"dual_matmul": 0, "fused_topk_retrieval": n_chunks, "fused_lgcnhs_serve": 0}
    check(f"large graph cli/main: (a)'s checkpoint loaded, recommend_gcn chunked, one retrieval "
          f"launch a chunk ({n_chunks})", counted == want, f"{counted}")
    check("large graph cli/main: six finite metrics",
          sorted(metrics) == sorted(["P", "R", "F1", "NDCG", "H", "I"])
          and all(math.isfinite(v) for v in metrics.values()), f"{metrics}")

    # every chunk's ids against the plain chain on the card
    cfg_main = cfg_for()
    rec = torch.from_numpy(np.load(os.path.join(
        cfg_main.recommend_path, f"all_user_recommend_LightGCNOpti_{cfg_main.k}.npy"))).to(dev)
    ue, ie = res_a.params
    rowptr, cols = scalable.user_csr(U, EdgeSet(np.r_[g.train.users, g.val.users],
                                                np.r_[g.train.items, g.val.items]))
    C = scalable.chunk_users(U, I, 1)
    cols_t = torch.from_numpy(cols.astype(np.int64)).to(dev)
    worst, identical = (1.0, 0.0), 0
    for s in range(0, U, C):
        e = min(s + C, U)
        seen = scalable.csr_rows_mask(rowptr, cols_t, s, e, I)
        plain = masked_topk(ue[s:e] @ ie.T, seen, cfg_main.k)
        if torch.equal(plain, rec[s:e]):
            identical += 1
            continue
        s64 = ue[s:e].double() @ ie.double().T
        ref = torch.where(seen, torch.full_like(s64, MASK_VALUE), s64)
        agreement, gap = tie_equivalence(torch, plain, rec[s:e], ref)
        worst = (min(worst[0], agreement), max(worst[1], gap))
        del s64, ref
    check(f"large graph cli/main: every chunk's ids identical to the plain chain on the card, "
          f"or tie-equivalent ({identical} of {n_chunks} identical)",
          worst[0] >= AGREEMENT_MIN and worst[1] <= GAP_MAX,
          f"worst agreement {worst[0]:.6f}, max relative gap {worst[1]:.3e}")

    # the kernels at this path's shapes against their twins, timed
    te = unique_edges(g.train)
    tr_rowptr, tr_cols = scalable.user_csr(U, te)
    seen0 = scalable.csr_rows_mask(tr_rowptr, torch.from_numpy(tr_cols.astype(np.int64)).to(dev),
                                   0, C, I)  # the first chunk of a CSR eval
    chunk_in = (ue[:C].contiguous(), ie, seen0, cfg_main.k)
    got, want_ = rt.fused_topk_retrieval(*chunk_in), rt.fused_topk_retrieval_ref(*chunk_in)
    out["chunk"] = {
        "shape": [C, I, ue.shape[1], cfg_main.k],
        "max_abs_err": (got[1] - want_[1]).abs().max().item(),
        "ms": median_ms(torch, lambda: rt.fused_topk_retrieval(*chunk_in), 10),
        "plain_ms": median_ms(torch, lambda: rt.fused_topk_retrieval_ref(*chunk_in), 10),
        "library_ms": None,
        "bound": bound(4 * (C + I) * ue.shape[1] + C * I + 8 * C * cfg_main.k,
                       2 * C * I * ue.shape[1]),
    }
    del seen0, got, want_
    R8, du, di = trainer.device_binary_factors(U, I, te, dev)
    R8p = prop.pad_for_dual(R8)
    X = (di[:, None] * ie).to(torch.bfloat16)
    Y = (du[:, None] * ue).to(torch.bfloat16)
    got = prop.dual_matmul(R8p, X, Y)
    want_ = prop.dual_matmul_ref(R8, X, Y)
    # the exact products summed in f64 over the edge list
    eu_t = torch.from_numpy(te.users.astype(np.int64)).to(dev)
    ei_t = torch.from_numpy(te.items.astype(np.int64)).to(dev)
    ref64 = (torch.zeros((U, X.shape[1]), dtype=torch.float64, device=dev)
             .index_add_(0, eu_t, X.double()[ei_t]),
             torch.zeros((I, Y.shape[1]), dtype=torch.float64, device=dev)
             .index_add_(0, ei_t, Y.double()[eu_t]))

    def rel_err(outs):
        return max((a.double() - r).abs().max().item() / r.abs().max().item()
                   for a, r in zip(outs, ref64))

    nnz = te.n_edges
    out["dual"] = {
        "shape": [U, I, ue.shape[1], nnz],
        "max_rel_err": rel_err(got), "twin_max_rel_err": rel_err(want_),
        "max_abs_err": max((a - b).abs().max().item() for a, b in zip(got, want_)),
        "ms": median_ms(torch, lambda: prop.dual_matmul(R8p, X, Y), 10),
        "plain_ms": median_ms(torch, lambda: prop.dual_matmul_ref(R8, X, Y), 3),
        "bound": bound(U * I + 2 * (I + U) * ue.shape[1] + 4 * (U + I) * ue.shape[1],
                       4 * nnz * ue.shape[1], PEAK_BF16_FLOP_PER_S),
    }
    del ref64, eu_t, ei_t
    check(f"large graph: dual_matmul at {U}x{I}x64 within {LARGE_DUAL_REL_TOL:g} of each "
          "output's scale of the exact (f64) products",
          out["dual"]["max_rel_err"] <= LARGE_DUAL_REL_TOL,
          f"kernel {out['dual']['max_rel_err']:.3e}, twin {out['dual']['twin_max_rel_err']:.3e}")
    print(f"[phase 6] kernels at this path's shapes: fused_topk_retrieval chunk "
          f"{json.dumps(out['chunk'])}; dual_matmul {json.dumps(out['dual'])} [{smi}]",
          flush=True)
    del R8, R8p, X, Y, got, want_, res_a, rec
    torch.cuda.empty_cache()

    # (b) compute.dtype=float32: the COO route (bucketed ELL), CSR eval
    run("(b)", cfg_for(**{"compute.dtype": "float32", "hparams.epochs": COO_EPOCHS}), g,
        (uf, itf), 1, COO_EPOCHS - 1,
        {"route": "COO bucketed + CSR eval", "iters": [0], "fused_topk_retrieval": n_chunks})
    torch.cuda.empty_cache()

    # (c) the bf16-dense rung (use_pallas=false) beside the kernel route, the
    # same seed and triple stream: only the incidence rounding differs
    short = {"hparams.epochs": SHORT_EPOCHS}
    kern = run("(c) beside the rung", cfg_for(**short), g, (uf, itf), 1, SHORT_EPOCHS - 1,
               {"route": "kernel route + CSR eval", "iters": [0],
                "dual_matmul": 6 * SHORT_EPOCHS, "fused_topk_retrieval": n_chunks})
    rung = run("(c) rung", cfg_for(**short, **{"compute.use_pallas": False}), g, (uf, itf), 1,
               SHORT_EPOCHS - 1, {"route": "bf16-dense rung + CSR eval", "iters": [0],
                                  "fused_topk_retrieval": n_chunks})
    worst = max(((a - b).abs() - RUNG_ATOL - RUNG_RTOL * b.abs()).max().item()
                for a, b in zip(rung.params, kern.params))
    gap = max((a - b).abs().max().item() for a, b in zip(rung.params, kern.params))
    check(f"large graph (c): the rung's tables within rtol {RUNG_RTOL:g}, atol {RUNG_ATOL:g} of "
          f"the kernel route's after {SHORT_EPOCHS} epochs", worst <= 0.0,
          f"max |gap| {gap:.3e}")
    del kern, rung
    torch.cuda.empty_cache()

    # the COO route against the dense f32 route at ML-1M, one seed
    over = {"compute.dtype": "float32", "hparams.epochs": TWIN_EPOCHS,
            "hparams.epoch_per_eval": 10}
    splits_m, ufm, ifm = load_dataset(cfg_for("movielens1m", **over))
    gm = build_graph(splits_m)
    dense_m = trainer.train_lightgcn(gm, cfg_for("movielens1m", **over), ufm, ifm,
                                     save_artifacts=False, device=dev)
    coo_m = trainer.train_lightgcn(gm, cfg_for("movielens1m", **over,
                                               **{"compute.dense_threshold": 1.0}),
                                   ufm, ifm, save_artifacts=False, device=dev)
    hd, hc = dense_m.history, coo_m.history
    loss_gap = max(abs(a - b) for col in ("train_loss", "val_loss")
                   for a, b in zip(hd[col], hc[col]))
    table_gap = max((a - b).abs().max().item() for a, b in zip(dense_m.params, coo_m.params))
    scale = max(t.abs().max().item() for t in dense_m.params)
    out["coo_vs_dense"] = {"loss_gap": loss_gap, "table_gap": table_gap, "table_scale": scale}
    print(f"[phase 6] ML-1M COO vs dense f32, {TWIN_EPOCHS} epochs: dense {json.dumps(hd)}, "
          f"COO {json.dumps(hc)}; max loss gap {loss_gap:.3e}, max table gap {table_gap:.3e} "
          f"(table scale {scale:.3e})", flush=True)
    check(f"ML-1M COO route tracks the dense f32 route over {TWIN_EPOCHS} epochs: losses",
          hd["iters"] == hc["iters"] and loss_gap <= COO_LOSS_TOL,
          f"max gap {loss_gap:.3e}, tolerance {COO_LOSS_TOL:g}")
    check(f"ML-1M COO route tracks the dense f32 route over {TWIN_EPOCHS} epochs: tables",
          table_gap <= COO_TABLE_TOL, f"max gap {table_gap:.3e}, tolerance {COO_TABLE_TOL:g}")
    shutil.rmtree(work, ignore_errors=True)
    return out


class SweepProbe:
    """Splits a lambda sweep's host seconds per grid point into diffusion
    (from the diffusion call to the ranking: W, A . W, G * F),
    ranking and metrics, the card synchronized around each part, by
    wrapping the names ``ops/sweep`` calls while it is active."""

    NAMES = ("hybrid_resource", "user_factored_diffusion_scores", "rank_exclude_seen_topk",
             "_metrics_for_rec")

    def __init__(self, torch, sweep):
        self.torch, self.sweep = torch, sweep
        self.seconds = {"diffusion": 0.0, "ranking": 0.0, "metrics": 0.0}
        self.points = 0

    def _mark(self):
        self.torch.cuda.synchronize()
        return time.perf_counter()

    def __enter__(self):
        self.saved = {name: getattr(self.sweep, name) for name in self.NAMES}

        def diffusion(fn):
            def call(*a, **kw):
                self.points += 1
                self.t_diffusion = self._mark()
                return fn(*a, **kw)
            return call

        def timed(fn, part):
            def call(*a, **kw):
                t0 = self._mark()
                if part == "ranking":
                    self.seconds["diffusion"] += t0 - self.t_diffusion
                out = fn(*a, **kw)
                self.seconds[part] += self._mark() - t0
                return out
            return call

        s = self.saved
        self.sweep.hybrid_resource = diffusion(s["hybrid_resource"])
        self.sweep.user_factored_diffusion_scores = diffusion(s["user_factored_diffusion_scores"])
        self.sweep.rank_exclude_seen_topk = timed(s["rank_exclude_seen_topk"], "ranking")
        self.sweep._metrics_for_rec = timed(s["_metrics_for_rec"], "metrics")
        return self

    def per_point(self):
        return {part: secs / max(self.points, 1) for part, secs in self.seconds.items()}

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.sweep, name, fn)
        return False


def lambda_resume_report_phase(check, dev, smi, env):
    """Phase 7: the single-device entry points on the card, on phase 4's
    workdirs. (a) ``cli/find_lambda`` at ML-1M over the full 101-point grid
    on the LightGCNOpti checkpoint phase 4 trained, its rows at lambda 0,
    0.5, the preset's 0.6 and 1 held against ``fused_recommend`` plus the
    evaluation on the card and against the sweep on the CPU; (b) the W-free
    flavor over the 49,410-item catalog at ``--step 0.25``; (c) resume on
    the ``dual_matmul`` route; (d) ``cli/evaluate`` over phase 4's cached
    lists and ``cli/ablation`` on its CSV. Returns the measurements."""
    import dataclasses
    import zipfile

    import numpy as np
    import torch

    from lgcnhs_tpu_torch.cli import ablation, evaluate, find_lambda
    from lgcnhs_tpu_torch.data.graph import interaction_matrix, pos_bool_matrix
    from lgcnhs_tpu_torch.eval import metrics as tev
    from lgcnhs_tpu_torch.models.fusion import allocate_matrix, fused_recommend
    from lgcnhs_tpu_torch.models.recommenders import checkpoint_path
    from lgcnhs_tpu_torch.ops import metrics_ops
    from lgcnhs_tpu_torch.ops import sweep as tsweep
    from lgcnhs_tpu_torch.ops.diffusion import general_spreading_matrix
    from lgcnhs_tpu_torch.ops.topk import rank_exclude_seen_topk
    from lgcnhs_tpu_torch.runtime.table import read_csv, rows_to_columns
    from lgcnhs_tpu_torch.train import checkpoint as tckpt
    from lgcnhs_tpu_torch.train import trainer
    from lgcnhs_tpu_torch.train.trainer import load_checkpoint

    kernels, graph, ml1m, big = env["kernels"], env["graph"], env["ml1m"], env["big"]
    work, train_work = env["work"], env["train_work"]
    out = {"runs": []}
    logged = []

    class Keep(logging.Handler):
        def emit(self, record):
            logged.append(record.getMessage())

    keep = Keep(logging.INFO)
    logging.getLogger("lgcnhs").addHandler(keep)

    def run(label, fn):
        """fn() with every launch count set to 0 just before and read just
        after; host seconds and peak device memory."""
        for f in kernels.values():
            f.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        row = {"run": label, "host_s": time.perf_counter() - t0,
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": {name: f.launches for name, f in kernels.items()}}
        out["runs"].append(row)
        print(f"[phase 7] {label}: {row['host_s']:.4f} s, peak device memory "
              f"{row['peak_device_gb']:.2f} GB, launches {row['launches']} [{smi}]", flush=True)
        return result, row

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def as_dict(row):
        return dict(zip(tsweep.METRIC_COLUMNS, (float(v) for v in row)))

    def spot_checks(label, cfg, g, rows, lambdas, spots, tall):
        """The sweep's rows at ``spots`` against fused_recommend + the
        evaluation at each lambda on the card (the lists identical, or
        tie-equivalent under f64 scores; the metrics by the phase-4 rule),
        and (dense flavor) against the same sweep run on the CPU."""
        k = cfg.k
        params = load_checkpoint(checkpoint_path(cfg), dev)
        A = cuda(interaction_matrix(g.n_users, g.n_items, g.train, g.val))
        seen = cuda(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val))
        ctx = tev.EvalContext.build(g.n_users, g.n_items, g.test, g.train, g.val, dev)
        G = allocate_matrix(params, seen)
        grid = lambdas[spots]
        ev = (ctx.on_device(ctx.eval_pos), ctx.on_device(ctx.eval_counts),
              ctx.on_device(ctx.eval_present))
        if tall:
            card = tsweep.lambda_sweep_metrics_tall(grid, G, A, seen, *ev,
                                                    ctx.on_device(ctx.item_deg), k)
        else:
            W_gen = general_spreading_matrix(A)
            S = metrics_ops.similarity_matrix(ctx.on_device(ctx.interaction),
                                              ctx.on_device(ctx.item_deg))
            card = tsweep.lambda_sweep_metrics(grid, G, A, W_gen, seen, *ev, S, k)
        card = card.cpu().numpy()
        check(f"{label}: the sweep over the spot points gives the CLI's rows",
              tsweep.sweep_rows(grid, card) == [rows[j] for j in spots])
        for n, (j, lam) in enumerate(zip(spots, grid)):
            lam_t = torch.tensor(lam)
            F = (tsweep.user_factored_diffusion_scores(A, lam_t) if tall
                 else tsweep.hybrid_resource(A, W_gen, lam_t))
            got = rank_exclude_seen_topk(G * F, seen, k)
            want = fused_recommend(params, A, seen, lam_t, k)
            agreement, gap = 1.0, 0.0
            if not torch.equal(got, want):
                ref = G.double() * F.double()
                agreement, gap = tie_equivalence(torch, want, got, ref)
                del ref
            del F
            per = unrounded(ctx, want.cpu().numpy(), tall)
            bad = metrics_disagree(rows[j], as_dict(card[n]), per)
            check(f"{label} lambda={rows[j]['lambda']}: the sweep's list equals "
                  "fused_recommend's (or tie-equivalent under f64), its row the evaluation's",
                  (agreement == 1.0 or (agreement >= AGREEMENT_MIN and gap <= GAP_MAX))
                  and not bad,
                  f"agreement {agreement:.6f}, gap {gap:.3e}; metrics disagree on {bad}")
        if not tall:
            t0 = time.perf_counter()
            A_h, seen_h = A.cpu(), seen.cpu()
            ctx_h = tev.EvalContext.build(g.n_users, g.n_items, g.test, g.train, g.val, "cpu")
            cpu = tsweep.lambda_sweep_metrics(
                grid, allocate_matrix(load_checkpoint(checkpoint_path(cfg), "cpu"), seen_h),
                A_h, general_spreading_matrix(A_h), seen_h,
                *(torch.from_numpy(x) for x in (ctx_h.eval_pos, ctx_h.eval_counts,
                                                ctx_h.eval_present)),
                metrics_ops.similarity_matrix(torch.from_numpy(ctx_h.interaction),
                                              torch.from_numpy(ctx_h.item_deg)), k).numpy()
            bad = {rows[j]["lambda"]: metrics_disagree(rows[j], as_dict(card[n]), as_dict(cpu[n]))
                   for n, j in enumerate(spots)}
            check(f"{label}: the spot rows equal the sweep on the CPU (or differ only across "
                  "a 5-decimal boundary within 1e-5)", not any(bad.values()),
                  f"{bad}; CPU {time.perf_counter() - t0:.2f} s")
        del G, A, seen
        torch.cuda.empty_cache()

    def sweep_run(label, args, step_grid, cfg, g, tall):
        with SweepProbe(torch, tsweep) as probe:
            rows, row = run(label, lambda: find_lambda.main(
                ["--device", "cuda", "--model", "SpreadLightGCNOpti", *args]))
        row["per_point_s"] = probe.per_point()
        row["points"] = probe.points
        print(f"[phase 7] {label}: {probe.points} points, per point (host s, card "
              f"synchronized) {json.dumps(row['per_point_s'])} [{smi}]", flush=True)
        check(f"{label}: no kernel launched (no training, no serving kernel)",
              not any(row["launches"].values()), f"{row['launches']}")
        lambdas = np.arange(0.0, 1.0 + step_grid, step_grid, dtype=np.float32)
        check(f"{label}: {len(lambdas)} rows, every metric finite in [0, 1]",
              [r["lambda"] for r in rows] == [round(float(x), 4) for x in lambdas]
              and all(0.0 <= r[m] <= 1.0 for r in rows for m in ("P", "R", "F1", "NDCG", "H", "I")))
        table = read_csv(os.path.join(cfg.evaluation_path, f"lambda_evaluation_{cfg.k}.csv"))
        check(f"{label}: lambda_evaluation_{cfg.k}.csv reads back the rows",
              table == rows_to_columns(rows))
        return rows, lambdas

    config = env["config"]  # (model, arguments, workdir) -> the config a CLI run resolves

    # (a) the full grid at ML-1M on phase 4's trained checkpoint
    cfg_a = config("SpreadLightGCNOpti", ml1m, train_work)
    logged.clear()
    rows_a, lambdas = sweep_run("find_lambda movielens1m, 101 points",
                                ["--workdir", train_work, *ml1m], 0.01, cfg_a, graph, False)
    check("find_lambda movielens1m: the dense flavor, the checkpoint loaded (not trained)",
          any(m.startswith("lambda sweep: dense flavor") for m in logged)
          and any(m.startswith("loaded cached LightGCNOpti checkpoint") for m in logged))
    spots = [int(np.argmin(np.abs(lambdas - lam))) for lam in
             (0.0, 0.5, cfg_a.hparams.lambda_, 1.0)]
    spot_checks("find_lambda movielens1m", cfg_a, graph, rows_a, lambdas, spots, False)
    best = max(rows_a, key=lambda r: r["R"])
    print(f"[phase 7] find_lambda movielens1m: best R@{cfg_a.k} {json.dumps(best)}; preset "
          f"{json.dumps(rows_a[spots[2]])}", flush=True)

    # (b) the W-free flavor over 49,410 items; nothing (I, I) may be built
    def no_ii(*a, **kw):
        raise AssertionError("an (I, I) operand was built on the W-free path")

    saved = {name: getattr(find_lambda, name) for name in
             ("general_spreading_matrix", "similarity_matrix", "lambda_sweep_metrics")}
    for name in saved:
        setattr(find_lambda, name, no_ii)
    logged.clear()
    cfg_b = config("SpreadLightGCNOpti", big, work)
    try:
        rows_b, lambdas_b = sweep_run(f"find_lambda {BIG_CATALOG}-item draw, 5 points",
                                      ["--workdir", work, *big, "--step", "0.25"], 0.25, cfg_b,
                                      env["big_graph"], True)
    finally:
        for name, fn in saved.items():
            setattr(find_lambda, name, fn)
    check(f"find_lambda {BIG_CATALOG}-item draw: the log names the W-free flavor",
          any("W-free flavor" in m for m in logged))
    spot_checks(f"find_lambda {BIG_CATALOG}-item draw", cfg_b, env["big_graph"], rows_b,
                lambdas_b, [2], True)

    # (c) resume on the dual_matmul route
    resume_work = tempfile.mkdtemp(prefix="chip_smoke_resume_", dir=os.path.join(ROOT, "artifacts"))

    def cfg_c(name, epochs):
        cfg = config("LightGCNOpti", ml1m, os.path.join(resume_work, name))
        return cfg.replace(hparams=dataclasses.replace(
            cfg.hparams, epochs=epochs, epoch_per_eval=RESUME_EVAL_EVERY))

    def train(name, epochs, **kw):
        return trainer.train_lightgcn(graph, cfg_c(name, epochs), *env["feats"], device=dev,
                                      **kw)

    full, row_full = run(f"train {RESUME_EPOCHS} epochs uninterrupted",
                         lambda: train("full", RESUME_EPOCHS))
    ckpt = os.path.join(resume_work, "ckpt")
    captured, io_ms = {}, {"save": [], "restore": []}
    real_save, real_restore = trainer.save_train_state, trainer.restore_train_state

    def save(path, epoch, params, opt_state):
        captured[epoch] = (tuple(t.detach().clone() for t in params),
                           {n: {m: v.clone() for m, v in s.items()} for n, s in opt_state.items()})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        written = real_save(path, epoch, params, opt_state)
        io_ms["save"].append((time.perf_counter() - t0) * 1e3)
        return written

    def restore(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = real_restore(*a, **kw)
        torch.cuda.synchronize()
        if got is not None:
            io_ms["restore"].append((time.perf_counter() - t0) * 1e3)
        return got

    trainer.save_train_state, trainer.restore_train_state = save, restore
    try:
        _, row_first = run(f"train {RESUME_STOP} epochs, checkpoint every {RESUME_EVERY}",
                           lambda: train("resumed", RESUME_STOP, checkpoint_dir=ckpt,
                                         checkpoint_every=RESUME_EVERY))
        restored = tckpt.restore_train_state(ckpt, dev)
        resumed, row_resumed = run(f"resume to {RESUME_EPOCHS} epochs",
                                   lambda: train("resumed", RESUME_EPOCHS, checkpoint_dir=ckpt,
                                                 checkpoint_every=RESUME_EVERY))
    finally:
        trainer.save_train_state, trainer.restore_train_state = real_save, real_restore
    launches = {"uninterrupted": row_full["launches"]["dual_matmul"],
                "interrupted_and_resumed": row_first["launches"]["dual_matmul"]
                + row_resumed["launches"]["dual_matmul"]}
    out["resume_launches"] = launches
    check(f"resume: dual_matmul launched 6 a step, {6 * RESUME_EPOCHS} in each of the two runs, "
          "no other kernel",
          launches == {"uninterrupted": 6 * RESUME_EPOCHS,
                       "interrupted_and_resumed": 6 * RESUME_EPOCHS}
          and not any(n for r in (row_full, row_first, row_resumed)
                      for name, n in r["launches"].items() if name != "dual_matmul"),
          f"{launches}")
    saved_epoch = RESUME_EVERY
    ok = restored is not None and restored[0] == saved_epoch and saved_epoch in captured
    if ok:
        s_params, s_state = captured[saved_epoch]
        ok = all(torch.equal(a, b) for a, b in zip(restored[1], s_params)) and all(
            torch.equal(restored[2][n][m].to(s_state[n][m].device), s_state[n][m])
            for n in s_state for m in s_state[n])
    check(f"resume: the restored state (tables, Adam's moments and step) equals the state saved "
          f"at epoch {saved_epoch} bitwise", ok)
    check(f"resume: one restore, from the epoch-{saved_epoch} checkpoint, logged",
          len(io_ms["restore"]) == 1
          and f"resumed from checkpoint at epoch {saved_epoch}" in logged)
    table_gap = max((a - b).abs().max().item() for a, b in zip(resumed.params, full.params))
    hist = {name: [] for name in full.history}
    for name in full.history:
        for e, a, b in zip(full.history["iters"], resumed.history[name], full.history[name]):
            if name != "val_loss" or e > saved_epoch:  # carried val losses: another val draw
                hist[name].append(abs(a - b))
    hist_gap = max(max(v) for v in hist.values() if v)
    out["resume"] = {"table_gap": table_gap, "history_gap": hist_gap, "io_ms": io_ms,
                     "table_scale": max(t.abs().max().item() for t in full.params)}
    print(f"[phase 7] resume vs uninterrupted, {RESUME_EPOCHS} epochs: max table gap "
          f"{table_gap:.3e} (scale {out['resume']['table_scale']:.3e}), max history gap "
          f"{hist_gap:.3e}; history {json.dumps(resumed.history)}; save ms {io_ms['save']}, "
          f"restore ms {io_ms['restore']} [{smi}]", flush=True)
    check("resume: the history covers the whole run (rows carried from the first run's CSV)",
          resumed.history["iters"] == full.history["iters"]
          == list(range(0, RESUME_EPOCHS, RESUME_EVAL_EVERY)), f"{resumed.history['iters']}")
    check(f"resume: tables within {RESUME_TABLE_TOL:g} and history within "
          f"{RESUME_HISTORY_TOL:g} of the uninterrupted run",
          table_gap <= RESUME_TABLE_TOL and hist_gap <= RESUME_HISTORY_TOL,
          f"table gap {table_gap:.3e}, history gap {hist_gap:.3e}")
    shutil.rmtree(resume_work, ignore_errors=True)

    # (d) cli/evaluate over phase 4's cached ML-1M lists, then the ablation
    sheets, row_d = run("evaluate movielens1m, 7 models at k=100", lambda: evaluate.main(
        ["--device", "cuda", "--workdir", work, *ml1m, "--ks", str(K_SLICE)]))
    check("evaluate: no kernel launched", not any(row_d["launches"].values()),
          f"{row_d['launches']}")
    got = {r["Model"]: {m: r[m] for m in ("P", "R", "F1", "NDCG", "H", "I")}
           for r in sheets.get(K_SLICE, [])}
    want = {m: env["main_metrics"].get(f"{m} movielens1m") for m in env["models"]}
    check("evaluate: each model's metric dict equals phase 4's cli/main JSON line",
          got == want, f"{got} against {want}")
    cfg_d = config("SpreadLightGCNOpti", ml1m, work)
    book = os.path.join(cfg_d.evaluation_path, "model_evaluation_results.xlsx")
    with zipfile.ZipFile(book) as zf:
        sheet_parts = [n for n in zf.namelist() if n.startswith("xl/worksheets/")]
        workbook = zf.read("xl/workbook.xml").decode()
        ok = zf.testzip() is None
    check("evaluate: the workbook opens as a zip with one sheet",
          ok and sheet_parts == ["xl/worksheets/sheet1.xml"] and f'name="{K_SLICE}"' in workbook)
    csv_rows = read_csv(os.path.join(cfg_d.evaluation_path, f"model_evaluation_{K_SLICE}.csv"))
    check(f"evaluate: model_evaluation_{K_SLICE}.csv reads back the rows",
          csv_rows == rows_to_columns(sheets.get(K_SLICE, [])))
    charts, _ = run("ablation movielens1m", lambda: ablation.main(
        ["--workdir", work, *ml1m, "--ks", str(K_SLICE)]))
    try:
        import matplotlib  # noqa: F401
        want_charts = 1
    except ImportError:
        want_charts = 0
    check(f"ablation: {want_charts} chart (matplotlib {'present' if want_charts else 'absent'})",
          len(charts) == want_charts, f"{charts}")
    logging.getLogger("lgcnhs").removeHandler(keep)
    return out


class PartTimer:
    """Host seconds of each ingestion part, by wrapping the names the
    dataset modules call while it is active: parse, ratings (filter, remap,
    split and the CSV artifacts), features (the tables, word2vec included)
    and word2vec (its plan on the host apart from its steps on the device;
    the vectors' copy to the host ends each call, so the card is done)."""

    def __init__(self, parts):
        self.parts = parts  # {part: [(module, attribute), ...]}
        self.seconds = dict.fromkeys(parts, 0.0)
        self.steps = []  # (steps, seconds) of each word2vec call

    def _wrap(self, part, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            dt = time.perf_counter() - t0
            self.seconds[part] += dt
            if part == "word2vec_plan":
                self.steps.append([out.n_steps, -dt])
            elif part == "word2vec" and self.steps:
                self.steps[-1][1] += dt
            return out
        return call

    def __enter__(self):
        self.saved = []
        for part, names in self.parts.items():
            for module, attr in names:
                self.saved.append((module, attr, getattr(module, attr)))
                setattr(module, attr, self._wrap(part, getattr(module, attr)))
        return self

    def __exit__(self, *exc):
        for module, attr, fn in reversed(self.saved):
            setattr(module, attr, fn)
        return False

    def row(self):
        steps = sum(n for n, _ in self.steps)
        step_s = sum(s for _, s in self.steps)
        return {**{k: v for k, v in self.seconds.items() if k != "word2vec_plan"},
                "word2vec_host_s": self.seconds["word2vec_plan"],
                "word2vec_steps": steps,
                "word2vec_ms_per_step": step_s * 1e3 / steps if steps else None}


def dual_accumulation_check(check, dev, smi):
    """Phase 6: ``dual_matmul``'s gap to the exact sums against the sum
    length L (``ACCUM_LENGTHS``): role U sums a row of R (128, L) against X,
    role I a column of R (L, 128) against Y, R all ones, X and Y bf16 (each
    product exact in f32). The plain twin (an f32 matmul) beside it.
    Returns the rows."""
    import torch

    from lgcnhs_tpu_torch.ops.cuda import propagation as prop

    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    for L, role, signs in itertools.product(ACCUM_LENGTHS, ("U", "I"), ("mixed", "positive")):
        shape = (ACCUM_WIDE, L) if role == "U" else (L, ACCUM_WIDE)
        R = torch.ones(shape, dtype=torch.int8, device=dev)
        X, Y = (torch.randn((n, 64), generator=gen, device=dev) for n in (shape[1], shape[0]))
        if signs == "positive":  # partial sums grow as L, not as sqrt(L)
            X, Y = X.abs(), Y.abs()
        X, Y = X.to(torch.bfloat16), Y.to(torch.bfloat16)
        side = 0 if role == "U" else 1
        exact = R.double() @ X.double() if role == "U" else R.double().T @ Y.double()
        scale = exact.abs().max().item()
        row = {"role": role, "L": L, "signs": signs}
        for name, fn in (("kernel", prop.dual_matmul), ("twin", prop.dual_matmul_ref)):
            err = fn(R, X, Y)[side].double() - exact
            row[name] = err.abs().max().item() / scale
            row[f"{name}_mean"] = err.mean().item() / scale
        rows.append(row)
        del R, X, Y, exact
    torch.cuda.empty_cache()
    print(f"[phase 6] dual_matmul gap to the exact sums by sum length (max and mean signed, "
          f"of scale): {json.dumps(rows)} [{smi}]", flush=True)
    worst = max(r["kernel"] for r in rows)
    check(f"dual_matmul: sums of up to {ACCUM_LENGTHS[-1]} bf16-exact products within "
          f"{ACCUM_REL_TOL:g} of each output's scale of the exact sums",
          worst <= ACCUM_REL_TOL, f"worst {worst:.3e}")
    return rows


def count_launches(kernels, run):
    """(run(), its launches by kernel name): every count set to 0 just
    before and read just after. Retrieval launches made inside
    ``chunked_masked_topk`` (the trainer's CSR evaluation,
    ``recommend_gcn``'s chunked branch) are counted apart, under
    ``CHUNKED``, as phase 6 counts them."""
    from lgcnhs_tpu_torch.models import recommenders
    from lgcnhs_tpu_torch.ops.cuda import retrieval as rt
    from lgcnhs_tpu_torch.train import trainer

    for fn in kernels.values():
        fn.launches = 0
    chunked = [0]
    saved = [(m, m.chunked_masked_topk) for m in (trainer, recommenders)]

    def wrap(topk):
        def call(*a, **kw):
            before = rt.fused_topk_retrieval.launches
            try:
                return topk(*a, **kw)
            finally:
                chunked[0] += rt.fused_topk_retrieval.launches - before
        return call

    for m, topk in saved:
        m.chunked_masked_topk = wrap(topk)
    try:
        result = run()
    finally:
        for m, topk in saved:
            m.chunked_masked_topk = topk
    counted = {name: fn.launches for name, fn in kernels.items()}
    counted["fused_topk_retrieval"] -= chunked[0]
    counted[CHUNKED] = chunked[0]
    return result, counted


def count_site_launches(kernels, fn):
    """(fn(), its launches by kernel name): ``count_launches``, with the
    retrieval launches made at the mesh CSR site
    (``parallel/sharding.chunked_masked_topk``) apart, under ``DISTRIBUTED``."""
    from lgcnhs_tpu_torch.ops.cuda import retrieval as rt
    from lgcnhs_tpu_torch.parallel import sharding

    saved, inside = sharding.chunked_masked_topk, [0]

    def site(*a, **kw):
        before = rt.fused_topk_retrieval.launches
        try:
            return saved(*a, **kw)
        finally:
            inside[0] += rt.fused_topk_retrieval.launches - before

    sharding.chunked_masked_topk = site
    try:
        out, got = count_launches(kernels, fn)
    finally:
        sharding.chunked_masked_topk = saved
    got["fused_topk_retrieval"] -= inside[0]
    got[DISTRIBUTED] = inside[0]
    return out, got


def mesh_phase(check, dev, smi, env):
    """Phase 9: the mesh on NCCL at world size 1 (module docstring). Returns
    its launches by kernel and its rows."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from lgcnhs_tpu_torch import config as tcfg
    from lgcnhs_tpu_torch.data.graph import (
        binary_incidence_factors, interaction_matrix, pos_bool_matrix, unique_edges,
    )
    from lgcnhs_tpu_torch.eval.metrics import EvalContext
    from lgcnhs_tpu_torch.models.fusion import (
        allocate_matrix, distributed_fused_recommend, fused_recommend,
    )
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
    from lgcnhs_tpu_torch.ops import diffusion as tdiff
    from lgcnhs_tpu_torch.ops import sweep as tsweep
    from lgcnhs_tpu_torch.ops.cuda import propagation as prop
    from lgcnhs_tpu_torch.ops.metrics_ops import similarity_matrix
    from lgcnhs_tpu_torch.ops.topk import MASK_VALUE, retrieve_topk
    from lgcnhs_tpu_torch.parallel import sharding
    from lgcnhs_tpu_torch.runtime.mesh import backend_for, make_mesh
    from lgcnhs_tpu_torch.train import trainer

    kernels = env["kernels"]
    launches = dict.fromkeys([*kernels, CHUNKED], 0)
    rows = []
    graph, (uf, itf) = env["graph"], env["feats"]
    U, I = graph.n_users, graph.n_items

    def counted(fn):
        """fn() with its launches counted (``count_launches``): phase 9's
        main-path launches."""
        out, got = count_launches(kernels, fn)
        torch.cuda.synchronize()
        for name, n in got.items():
            launches[name] += n
        return out, got

    def row(name, shape, mesh_ms, single_ms, **extra):
        rows.append({"name": name, "shape": shape, "mesh_ms": mesh_ms, "single_ms": single_ms,
                     "collective_ms": mesh_ms - single_ms, **extra})
        print(f"[phase 9] {name} {shape}: mesh {mesh_ms:.4f} ms, single device "
              f"{single_ms:.4f} ms ({mesh_ms - single_ms:+.4f}) {json.dumps(extra)} [{smi}]",
              flush=True)

    def host_ms(fn, reps=3):
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[reps // 2]

    store = tempfile.mkdtemp(prefix="chip_smoke_nccl_", dir=os.path.join(ROOT, "artifacts"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), world_size=1, rank=0,
                            init_method=f"file://{os.path.join(store, 'store')}")
    try:
        check("phase 9: a world-1 process group on NCCL",
              dist.get_backend() == "nccl" and dist.get_world_size() == 1, dist.get_backend())
        mesh = make_mesh((1, 1))
        check("phase 9: make_mesh((1, 1)) on the card",
              mesh.device == dev and mesh.shape == {"data": 1, "model": 1}, repr(mesh))

        # (a) training: the trainer's mesh function against the single-device
        # kernel route, one seed
        cfg = tcfg.load_config(env="prod", dataset="movielens1m", model="LightGCNOpti",
                               overrides={"hparams.epochs": TWIN_EPOCHS,
                                          "hparams.epoch_per_eval": 10})
        t0 = time.perf_counter()
        single = trainer.train_lightgcn(graph, cfg, uf, itf, save_artifacts=False, device=dev)
        single_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        meshed, got = counted(lambda: trainer.train_lightgcn_on_mesh(
            graph, cfg, mesh, uf, itf, save_artifacts=False))
        mesh_s = time.perf_counter() - t0
        want = {name: 6 * TWIN_EPOCHS if name == "dual_matmul" else 0 for name in launches}
        check(f"phase 9: mesh training launched dual_matmul 6 x {TWIN_EPOCHS} and nothing else",
              got == want, f"{got}")
        hist_gap = max(abs(a - b) for col in single.history
                       for a, b in zip(single.history[col], meshed.history[col]))
        table_gap = max((a - b).abs().max().item() for a, b in zip(single.params, meshed.params))
        check(f"phase 9: mesh training tracks the single-device kernel route over {TWIN_EPOCHS} "
              "epochs: history", hist_gap <= TWIN_LOSS_TOL and
              single.history["iters"] == meshed.history["iters"],
              f"max gap {hist_gap:.3e}, tolerance {TWIN_LOSS_TOL:g}")
        check(f"phase 9: mesh training tracks the single-device kernel route over {TWIN_EPOCHS} "
              "epochs: tables", table_gap <= TWIN_TABLE_TOL,
              f"max gap {table_gap:.3e}, tolerance {TWIN_TABLE_TOL:g}")
        row("train_lightgcn (20 epochs, 2 evals)", [U, I, 64], mesh_s * 1e3, single_s * 1e3,
            history_gap=hist_gap, table_gap=table_gap, launches=got)

        # the train step alone, the two routes in turns
        hp = cfg.hparams
        te = unique_edges(graph.train)
        p_init = trainer._init_params(graph, cfg, uf, itf, "cpu", torch.float32)[0]
        pos = pos_bool_matrix(U, I, graph.train)
        R8, du, di = trainer.device_binary_factors(U, I, graph.train, dev)
        p_s = LightGCNParams(*(t.to(dev, copy=True).requires_grad_(True) for t in p_init))
        step_s = trainer.make_train_step(trainer.make_optimizer(hp, p_s), hp, I,
                                         bf16_matmul=True, use_kernel=True)
        args_s = ((prop.pad_for_dual(R8), du, di),
                  torch.from_numpy(te.users.astype(np.int64)).to(dev),
                  torch.from_numpy(te.items.astype(np.int64)).to(dev), torch.from_numpy(pos).to(dev))
        plan = sharding.make_plan(mesh)
        (R8b, dub, dib), pos_b, eu_b, ei_b = sharding.shard_train_inputs(
            plan, binary_incidence_factors(U, I, graph.train), pos, te.users, te.items)
        args_m = ((prop.pad_for_dual(R8b), dub, dib), eu_b, ei_b, pos_b)
        p_m = LightGCNParams(*(t.requires_grad_(True) for t in sharding.shard_params(plan, p_init)))
        step_m = sharding.make_sharded_train_step(plan, trainer.make_optimizer(hp, p_m), hp, I,
                                                  bf16_matmul=True)
        epochs = {"single": 0, "mesh": 0}

        def steps(route, n):
            step, params, args = ((step_s, p_s, args_s) if route == "single"
                                  else (step_m, p_m, args_m))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                e = epochs[route]
                epochs[route] += 1
                step(params, e, trainer.epoch_generator(hp.seed, e, dev), *args)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        steps("single", 20), steps("mesh", 20)
        ms = {"single": [], "mesh": []}
        for route in ("single", "mesh", "mesh", "single"):
            ms[route].append(steps(route, 100))
        row("train step (int8 dual_matmul route, B=1024)", [U, I, 64],
            float(np.mean(ms["mesh"])), float(np.mean(ms["single"])),
            mesh_runs=ms["mesh"], single_runs=ms["single"])
        del p_s, p_m, args_s, args_m, R8, R8b, step_s, step_m
        torch.cuda.empty_cache()

        # (b) retrieval: the item-sharded top-k against retrieve_topk
        for (g, params, k, label) in env["retrieval"]:
            ue, ie = params.user_emb.to(dev), params.item_emb.to(dev)
            seen = torch.from_numpy(pos_bool_matrix(g.n_users, g.n_items, g.train,
                                                    g.val)).to(dev)
            want_ids = retrieve_topk(ue, ie, seen, k)
            got_ids, got = counted(lambda: sharding.distributed_retrieve_topk(mesh, ue, ie, seen,
                                                                              k))
            check(f"phase 9: distributed_retrieve_topk {label} k={k}: one fused_topk_retrieval "
                  "launch", got == {name: int(name == "fused_topk_retrieval") for name in launches},
                  f"{got}")
            check(f"phase 9: distributed_retrieve_topk {label} k={k}: ids identical to "
                  "retrieve_topk", torch.equal(got_ids, want_ids),
                  f"{int((got_ids != want_ids).sum())} mismatches")
            row(f"distributed_retrieve_topk {label} k={k}", [g.n_users, g.n_items, 64, k],
                median_ms(torch, lambda: sharding.distributed_retrieve_topk(mesh, ue, ie, seen,
                                                                            k), 10),
                median_ms(torch, lambda: retrieve_topk(ue, ie, seen, k), 10))
            del seen, want_ids, got_ids
        torch.cuda.empty_cache()

        # (c) fused ranking and (d) diffusion at ML-1M
        params = env["fused_params"]
        params = LightGCNParams(params.user_emb.to(dev), params.item_emb.to(dev))
        A = torch.from_numpy(interaction_matrix(U, I, graph.train, graph.val)).to(dev)
        seen = torch.from_numpy(pos_bool_matrix(U, I, graph.train, graph.val)).to(dev)
        lam = torch.tensor(0.6, dtype=torch.float32)
        want_ids = fused_recommend(params, A, seen, lam, K_SLICE)
        got_ids, got = counted(lambda: distributed_fused_recommend(mesh, params, A, seen, lam,
                                                                   K_SLICE))
        check("phase 9: distributed_fused_recommend launches no kernel (JAX ranks it in XLA)",
              not any(got.values()), f"{got}")
        F64 = tdiff.diffusion_scores(A.double(), lam.double())
        ref = F64 * torch.where(seen, torch.full_like(F64, MASK_VALUE),
                                params.user_emb.double() @ params.item_emb.double().T)
        agreement, gap = tie_equivalence(torch, want_ids, got_ids, ref)
        check("phase 9: distributed_fused_recommend at ML-1M identical to fused_recommend, or "
              "tie-equivalent under f64", agreement == 1.0 or
              (agreement >= AGREEMENT_MIN and gap <= GAP_MAX),
              f"agreement {agreement:.6f}, mismatched-slot max relative gap {gap:.3e}")
        del F64, ref
        row(f"distributed_fused_recommend k={K_SLICE}", [U, I, 64, K_SLICE],
            host_ms(lambda: distributed_fused_recommend(mesh, params, A, seen, lam, K_SLICE)),
            host_ms(lambda: fused_recommend(params, A, seen, lam, K_SLICE)),
            agreement=agreement)
        F_single = tdiff.diffusion_scores(A, lam)
        F_mesh, got = counted(lambda: sharding.sharded_diffusion_scores(mesh, A, lam))
        diff_gap = (F_mesh - F_single).abs().max().item() / F_single.abs().max().item()
        check(f"phase 9: sharded_diffusion_scores within {MESH_DIFF_TOL:g} of scale of "
              "diffusion_scores", diff_gap <= MESH_DIFF_TOL and not any(got.values()),
              f"{diff_gap:.3e}, launches {got}")
        del F_single, F_mesh
        row("sharded_diffusion_scores", [U, I],
            host_ms(lambda: sharding.sharded_diffusion_scores(mesh, A, lam)),
            host_ms(lambda: tdiff.diffusion_scores(A, lam)), rel_gap=diff_gap)

        # (e) the sharded sweeps over MESH_SWEEP_POINTS points
        ctx = EvalContext.build(U, I, graph.test, graph.train, graph.val, dev)
        G = allocate_matrix(params, seen)
        lams = np.linspace(0.0, 1.0, MESH_SWEEP_POINTS).astype(np.float32)
        eval_args = (ctx.on_device(ctx.eval_pos), ctx.on_device(ctx.eval_counts),
                     ctx.on_device(ctx.eval_present))
        deg = ctx.on_device(ctx.item_deg)

        def single_sweep():
            W_gen = tdiff.general_spreading_matrix(A)
            S = similarity_matrix(ctx.on_device(ctx.interaction), deg)
            return tsweep.lambda_sweep_metrics(lams, G, A, W_gen, seen, *eval_args, S, K_SLICE)

        want_rows = single_sweep()
        for layout, budget in (("grid-parallel", tsweep.SWEEP_REPLICATION_BUDGET_BYTES),
                               ("item-sharded", 1)):
            def sweep():
                return tsweep.sharded_lambda_sweep(mesh, lams, G, A, None, seen, *eval_args,
                                                   None, k=K_SLICE, memory_budget_bytes=budget,
                                                   item_deg=deg)

            got_rows, got = counted(sweep)
            rel = ((got_rows - want_rows).abs() / want_rows.abs().clamp_min(1e-30)).max().item()
            same = tsweep.sweep_rows(lams, got_rows.cpu().numpy()) == \
                tsweep.sweep_rows(lams, want_rows.cpu().numpy())
            check(f"phase 9: sharded_lambda_sweep ({layout}) at ML-1M over "
                  f"{MESH_SWEEP_POINTS} points: rows equal lambda_sweep_metrics'",
                  same and rel <= MESH_SWEEP_RTOL and not any(got.values()),
                  f"max relative gap {rel:.3e}, launches {got}")
            row(f"sharded_lambda_sweep {layout} ({MESH_SWEEP_POINTS} points)", [U, I, K_SLICE],
                host_ms(sweep), host_ms(single_sweep), max_rel_gap=rel)
        del A, seen, G, ctx
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return {"launches": launches, "rows": rows}


def mesh_large_phase(check, dev, smi, env):
    """Phase 10: the mesh's large-graph half on NCCL at world size 1, on
    phase 6's large graph at the prod preset (module docstring). Returns
    its launches by kernel and call site, its rows and the measurements of
    the retrieval kernel at its distributed call site."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from lgcnhs_tpu_torch import config as tcfg
    from lgcnhs_tpu_torch.cli import scaling
    from lgcnhs_tpu_torch.data.datasets import load_dataset
    from lgcnhs_tpu_torch.data.graph import build_graph, unique_edges
    from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
    from lgcnhs_tpu_torch.ops import scalable
    from lgcnhs_tpu_torch.ops.cuda import retrieval as rt
    from lgcnhs_tpu_torch.ops.propagation import build_bucketed_incidence, edge_gcn_norm
    from lgcnhs_tpu_torch.ops.topk import MASK_VALUE
    from lgcnhs_tpu_torch.parallel import sharding
    from lgcnhs_tpu_torch.runtime.mesh import backend_for, make_mesh
    from lgcnhs_tpu_torch.train import trainer

    kernels = env["kernels"]
    launches = dict.fromkeys([*kernels, CHUNKED, DISTRIBUTED], 0)
    rows = []
    sizes = {"synthetic_users": LARGE_USERS, "synthetic_items": LARGE_ITEMS,
             "synthetic_interactions": LARGE_INTERACTIONS}
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_large_", dir=os.path.join(ROOT, "artifacts"))

    def cfg_for(**over):
        return tcfg.load_config(env="prod", dataset="synthetic", model="LightGCNOpti",
                                workdir=work, overrides={**sizes, **over})

    splits, uf, itf = load_dataset(cfg_for())
    g = build_graph(splits)
    U, I, E = g.n_users, g.n_items, g.train.n_edges
    n_chunks = -(-U // scalable.chunk_users(U, I, 1))
    probe = {"retrieval_s": [], "iak_s": []}

    def timed(fn, into):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return call

    def counted(fn):
        """fn() with its launches counted (``count_site_launches``: the mesh's
        CSR evaluation's retrieval launches apart, under ``DISTRIBUTED``), its
        CSR retrieval and I@k host seconds (the card synchronized around each
        call); phase 10's main-path launches."""
        saved = (sharding.chunked_masked_topk, trainer.internal_similarity_csr,
                 trainer.chunked_masked_topk)
        probe["retrieval_s"], probe["iak_s"] = [], []
        sharding.chunked_masked_topk = timed(saved[0], probe["retrieval_s"])
        trainer.internal_similarity_csr = timed(saved[1], probe["iak_s"])
        trainer.chunked_masked_topk = timed(saved[2], probe["retrieval_s"])
        try:
            t0 = time.perf_counter()
            out, got = count_site_launches(kernels, fn)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            (sharding.chunked_masked_topk, trainer.internal_similarity_csr,
             trainer.chunked_masked_topk) = saved
        for name, n in got.items():
            launches[name] += n
        return out, got, secs

    def row(name, shape, mesh_ms, single_ms, **extra):
        rows.append({"name": name, "shape": shape, "mesh_ms": mesh_ms, "single_ms": single_ms,
                     **extra})
        print(f"[phase 10] {name} {shape}: mesh {mesh_ms} ms, single device {single_ms} ms "
              f"{json.dumps(extra)} [{smi}]", flush=True)

    def gaps(a, b):
        """(max history gap, max table gap) of two TrainResults."""
        hist = max(abs(x - y) for col in a.history for x, y in zip(a.history[col],
                                                                    b.history[col]))
        return hist, max((x - y).abs().max().item() for x, y in zip(a.params, b.params))

    no_kernel = dict.fromkeys(launches, 0)
    out = {}
    store = tempfile.mkdtemp(prefix="chip_smoke_nccl10_", dir=os.path.join(ROOT, "artifacts"))
    torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), world_size=1, rank=0,
                            init_method=f"file://{os.path.join(store, 'store')}")
    try:
        mesh = make_mesh((1, 1))
        check("phase 10: make_mesh((1, 1)) on a world-1 NCCL group",
              dist.get_backend() == "nccl" and mesh.device == dev, repr(mesh))
        prod = cfg_for()
        check("phase 10: on a mesh the large graph takes the COO route at the prod preset "
              "(no bf16 expansion), on one device the dense side",
              trainer.choose_propagation(U, I, E, prod.compute, single_chip=False) == "coo"
              and trainer.choose_propagation(U, I, E, prod.compute, single_chip=True) == "dense")

        # (a) the mesh trainer against the single-device COO route, one seed
        cfg = cfg_for(**{"compute.dtype": "float32", "hparams.epochs": TWIN_EPOCHS,
                         "hparams.epoch_per_eval": TWIN_EPOCHS})
        single, got_s, single_s = counted(lambda: trainer.train_lightgcn(
            g, cfg, uf, itf, save_artifacts=False, device=dev))
        single_split = dict(probe)
        meshed, got_m, mesh_s = counted(lambda: trainer.train_lightgcn_on_mesh(
            g, cfg, mesh, uf, itf, save_artifacts=False))
        mesh_split = dict(probe)
        check(f"phase 10 (a): the single-device COO route: {n_chunks} chunked retrieval "
              "launches and nothing else", got_s == {**no_kernel, CHUNKED: n_chunks}, f"{got_s}")
        check(f"phase 10 (a): mesh training launched no dual_matmul and {n_chunks} retrieval "
              "launches at the distributed CSR site, nothing else",
              got_m == {**no_kernel, DISTRIBUTED: n_chunks}, f"{got_m}")
        hist_gap, table_gap = gaps(single, meshed)
        check(f"phase 10 (a): mesh COO training tracks the single-device COO route over "
              f"{TWIN_EPOCHS} epochs: history", hist_gap <= TWIN_LOSS_TOL
              and single.history["iters"] == meshed.history["iters"] == [0],
              f"max gap {hist_gap:.3e}, tolerance {TWIN_LOSS_TOL:g}")
        check(f"phase 10 (a): mesh COO training tracks the single-device COO route over "
              f"{TWIN_EPOCHS} epochs: tables", table_gap <= TWIN_TABLE_TOL,
              f"max gap {table_gap:.3e}, tolerance {TWIN_TABLE_TOL:g}")
        row(f"train_lightgcn COO ({TWIN_EPOCHS} epochs, 1 CSR eval)", [U, I, 64],
            mesh_s * 1e3, single_s * 1e3, history_gap=hist_gap, table_gap=table_gap,
            mesh_retrieval_s=mesh_split["retrieval_s"], mesh_iak_s=mesh_split["iak_s"],
            single_retrieval_s=single_split["retrieval_s"], single_iak_s=single_split["iak_s"],
            launches=got_m)
        torch.cuda.empty_cache()

        # (b) one step of each layout on the same triples, then their ms a step
        hp = cfg.hparams
        te = unique_edges(g.train)
        eu_t = torch.from_numpy(te.users.astype(np.int64)).to(dev)
        ei_t = torch.from_numpy(te.items.astype(np.int64)).to(dev)
        rowptr, cols = scalable.user_csr(U, te)
        keys = scalable.csr_keys(rowptr, cols, dev)
        norm = edge_gcn_norm(eu_t, ei_t, U, I)
        plan = sharding.make_plan(mesh)
        t0 = time.perf_counter()
        se = {"bucketed": sharding.shard_bucketed_incidence(plan, te.users, te.items,
                                                            norm.cpu().numpy(), U, I)}
        build_s = {"bucketed": time.perf_counter() - t0}
        t0 = time.perf_counter()
        se["segment"] = sharding.shard_coo_edges(plan, te.users, te.items, norm)
        build_s["segment"] = time.perf_counter() - t0
        p_init = trainer._init_params(g, cfg, uf, itf, "cpu", torch.float32)[0]
        runs = {}
        for layout in ("bucketed", "segment"):
            params = LightGCNParams(*(t.to(dev, copy=True).requires_grad_(True) for t in p_init))
            step = sharding.make_sharded_coo_train_step(plan, trainer.make_optimizer(hp, params),
                                                        hp, U, I, layout=layout)
            loss = step(params, 0, trainer.epoch_generator(hp.seed, 0, dev), se[layout], eu_t,
                        ei_t, keys)
            runs[layout] = [step, params, loss.item(), 1, (se[layout], eu_t, ei_t, keys)]
        params_1 = LightGCNParams(*(t.to(dev, copy=True).requires_grad_(True) for t in p_init))
        binc = build_bucketed_incidence(te.users, te.items, norm.cpu().numpy(), U, I, device=dev)
        runs["single"] = [trainer.make_coo_train_step(trainer.make_optimizer(hp, params_1), hp, I),
                          params_1, None, 0, (binc, eu_t, ei_t, keys)]
        (_, pb, lb, _, _), (_, ps, ls, _, _) = runs["bucketed"], runs["segment"]
        scale = max(t.abs().max().item() for t in pb)
        step_gap = max((a - b).abs().max().item() for a, b in zip(pb, ps)) / scale
        loss_gap = abs(lb - ls) / abs(lb)
        check(f"phase 10 (b): one step of the segment layout within {LAYOUT_REL_TOL:g} of scale "
              "of the bucketed layout's (loss and tables)",
              loss_gap <= LAYOUT_REL_TOL and step_gap <= LAYOUT_REL_TOL,
              f"loss {loss_gap:.3e}, tables {step_gap:.3e}")

        def steps(name, n):
            run = runs[name]
            step, params, args = run[0], run[1], run[4]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                step(params, run[3], trainer.epoch_generator(hp.seed, run[3], dev), *args)
                run[3] += 1
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / n

        ms = {name: [] for name in runs}
        for name in ("single", "bucketed", "segment"):
            steps(name, 3)
        for name in ("single", "bucketed", "segment", "segment", "bucketed", "single"):
            ms[name].append(steps(name, 10))
        for layout in ("bucketed", "segment"):
            row(f"sharded COO step, {layout} layout (B={hp.batch_size})", [U, I, 64, E],
                float(np.mean(ms[layout])), float(np.mean(ms["single"])), runs=ms[layout],
                single_runs=ms["single"], se_build_s=build_s[layout],
                first_step_loss_gap=loss_gap, first_step_table_gap=step_gap)
        del runs, se, binc, params_1, p_init
        torch.cuda.empty_cache()

        # (c) the table-sharded plan against the replicated plan of (a)
        cfg_ts = cfg_for(**{"compute.dtype": "float32", "hparams.epochs": TWIN_EPOCHS,
                            "hparams.epoch_per_eval": TWIN_EPOCHS,
                            "compute.coo_table_sharding": True})
        sharded, got_t, ts_s = counted(lambda: trainer.train_lightgcn_on_mesh(
            g, cfg_ts, mesh, uf, itf, save_artifacts=False))
        ts_hist, ts_table = gaps(meshed, sharded)
        check(f"phase 10 (c): the table-sharded plan's history within "
              f"{TABLE_SHARDED_HISTORY_TOL:g} of the replicated plan's over {TWIN_EPOCHS} epochs",
              ts_hist <= TABLE_SHARDED_HISTORY_TOL and got_t == {**no_kernel,
                                                                  DISTRIBUTED: n_chunks},
              f"max gap {ts_hist:.3e}, tables {ts_table:.3e}, launches {got_t}")
        row(f"train_lightgcn COO table-sharded vs replicated ({TWIN_EPOCHS} epochs)", [U, I, 64],
            ts_s * 1e3, mesh_s * 1e3, history_gap=ts_hist, table_gap=ts_table, launches=got_t,
            note="single_ms is the replicated mesh plan's")
        del sharded
        torch.cuda.empty_cache()

        # (d) the mesh CSR evaluation against chunked_masked_topk, k=100
        ue, ie = meshed.params
        run = sharding.make_distributed_csr_masked_topk(mesh, rowptr, cols, U)
        want_ids = scalable.chunked_masked_topk(ue, ie, rowptr, cols, K_SLICE)
        got_ids, got_d, _ = counted(lambda: run(ue, ie, K_SLICE))
        check(f"phase 10 (d): make_distributed_csr_masked_topk ids identical to "
              f"chunked_masked_topk at k={K_SLICE}, {n_chunks} launches",
              torch.equal(got_ids, want_ids) and got_d == {**no_kernel, DISTRIBUTED: n_chunks},
              f"{int((got_ids != want_ids).sum())} mismatches, launches {got_d}")

        def host_ms(fn, reps=3):
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return sorted(times)[reps // 2]

        ms_d = host_ms(lambda: run(ue, ie, K_SLICE))
        ms_c = host_ms(lambda: scalable.chunked_masked_topk(ue, ie, rowptr, cols, K_SLICE))
        ms_d2 = host_ms(lambda: run(ue, ie, K_SLICE))
        row(f"make_distributed_csr_masked_topk vs chunked_masked_topk k={K_SLICE}",
            [U, I, 64, K_SLICE], (ms_d + ms_d2) / 2, ms_c, mesh_runs=[ms_d, ms_d2],
            chunks=n_chunks)
        # the kernel at this site's shapes: the first chunk of the rank's block
        C = scalable.chunk_users(U, I, 1)
        seen0 = scalable.csr_rows_mask(rowptr, torch.from_numpy(cols.astype(np.int64)).to(dev),
                                       0, C, I)
        chunk_in = (ue[:C].contiguous(), ie.contiguous(), seen0, K_SLICE)
        got_k, want_k = rt.fused_topk_retrieval(*chunk_in), rt.fused_topk_retrieval_ref(*chunk_in)
        D = ue.shape[1]

        def composition():
            return torch.topk(torch.matmul(chunk_in[0], ie.T).masked_fill_(seen0, MASK_VALUE),
                              K_SLICE, dim=1)

        out["site"] = {
            "shape": [C, I, D, K_SLICE],
            "max_abs_err": (got_k[1] - want_k[1]).abs().max().item(),
            "ids_identical": bool(torch.equal(got_k[0], want_k[0])),
            "ms": median_ms(torch, lambda: rt.fused_topk_retrieval(*chunk_in), 10),
            "plain_ms": median_ms(torch, lambda: rt.fused_topk_retrieval_ref(*chunk_in), 10),
            "matmul_topk_ms": median_ms(torch, composition, 10),
            "bound": bound(4 * (C + I) * D + C * I + 8 * C * K_SLICE, 2 * C * I * D),
        }
        print(f"[phase 10] fused_topk_retrieval at the distributed CSR site: "
              f"{json.dumps(out['site'])} [{smi}]", flush=True)
        del seen0, got_k, want_k, meshed, single, ue, ie
        torch.cuda.empty_cache()

        # (e) resume: stopped after a checkpoint and resumed, against one run,
        # on the mesh COO route, the single-device COO route and the rung.
        # These runs' evaluations (epoch 0) skip I@k: its host Gram takes
        # ~5 s an evaluation and reads the tables, writes none.
        resume_rows = {}
        saved_iak = trainer.internal_similarity_csr
        trainer.internal_similarity_csr = lambda *a, **kw: 0.0
        try:
            routes = {
                "mesh COO": ({"compute.dtype": "float32"},
                             lambda c, **kw: trainer.train_lightgcn_on_mesh(
                                 g, c, mesh, uf, itf, save_artifacts=False, **kw)),
                "single-device COO": ({"compute.dtype": "float32"},
                                      lambda c, **kw: trainer.train_lightgcn(
                                          g, c, uf, itf, save_artifacts=False, device=dev, **kw)),
                "bf16-dense rung": ({"compute.use_pallas": False},
                                    lambda c, **kw: trainer.train_lightgcn(
                                        g, c, uf, itf, save_artifacts=False, device=dev, **kw)),
            }
            for label, (over, train) in routes.items():
                ckpt = os.path.join(work, "ckpt_" + label.replace(" ", "_"))

                def resume_cfg(epochs):
                    return cfg_for(**over, **{"hparams.epochs": epochs,
                                              "hparams.epoch_per_eval": RESUME_EPOCHS_10})

                t0 = time.perf_counter()
                full, got_f, _ = counted(lambda: train(resume_cfg(RESUME_EPOCHS_10)))
                counted(lambda: train(resume_cfg(RESUME_STOP_10), checkpoint_dir=ckpt,
                                      checkpoint_every=RESUME_EVERY_10))
                resumed, got_r, _ = counted(lambda: train(resume_cfg(RESUME_EPOCHS_10),
                                                          checkpoint_dir=ckpt,
                                                          checkpoint_every=RESUME_EVERY_10))
                gap = max((a - b).abs().max().item() for a, b in zip(full.params, resumed.params))
                resume_rows[label] = {"table_gap": gap, "seconds": time.perf_counter() - t0,
                                      "resumed_launches": got_r}
                check(f"phase 10 (e): resume on the {label} route ({RESUME_STOP_10} epochs, a "
                      f"checkpoint at {RESUME_EVERY_10}, on to {RESUME_EPOCHS_10}): tables within "
                      f"{RESUME_TABLE_TOL:g} of one run", gap <= RESUME_TABLE_TOL,
                      f"max gap {gap:.3e}, resumed run's launches {got_r}")
                del full, resumed
                torch.cuda.empty_cache()
        finally:
            trainer.internal_similarity_csr = saved_iak
        print(f"[phase 10] (e) resume {json.dumps(resume_rows)} [{smi}]", flush=True)
        out["resume"] = resume_rows
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)

    # (f) cli/scaling on one card: each rung its own NCCL process group
    torch.cuda.empty_cache()
    for flags in ([], ["--coo"]):
        t0 = time.perf_counter()
        got = scaling.main(["--meshes", "1", "--steps", "10", *flags])
        secs = time.perf_counter() - t0
        check(f"phase 10 (f): cli/scaling --meshes 1 {' '.join(flags)}: one row, efficiency 1.0",
              len(got) == 1 and got[0]["devices"] == 1 and got[0]["efficiency"] == 1.0
              and got[0]["examples_per_sec"] > 0, f"{got} in {secs:.2f} s")
        rows.append({"name": f"cli/scaling --meshes 1 {' '.join(flags)}".strip(), "rows": got,
                     "host_s": secs})
    out.update(launches=launches, rows=rows)
    return out


def ingestion_phase(check, dev, smi, clock):
    """Phase 8: raw files through ``--data-dir`` on the card (module
    docstring). Returns the launches of its main-path runs by kernel and its
    rows."""
    import numpy as np
    import torch

    from lgcnhs_tpu_torch import config as tcfg
    from lgcnhs_tpu_torch.cli import main as cli_main
    from lgcnhs_tpu_torch.cli import retrieve
    from lgcnhs_tpu_torch.data import douban as tdb
    from lgcnhs_tpu_torch.data import features as tf
    from lgcnhs_tpu_torch.data import movielens as tml
    from lgcnhs_tpu_torch.data import movielens1m as tm1
    from lgcnhs_tpu_torch.data import word2vec as tw
    from lgcnhs_tpu_torch.data.datasets import load_dataset
    from lgcnhs_tpu_torch.data.fetch import douban_paths, ml100k_paths, ml1m_paths
    from lgcnhs_tpu_torch.data.graph import build_graph, interaction_matrix, pos_bool_matrix
    from lgcnhs_tpu_torch.data.idmap import IdMapper
    from lgcnhs_tpu_torch.data.synthetic import synthesize_movielens_like
    from lgcnhs_tpu_torch.eval import metrics as tev
    from lgcnhs_tpu_torch.models.recommenders import checkpoint_path, recommend
    from lgcnhs_tpu_torch.native import bindings as native
    from lgcnhs_tpu_torch.ops import diffusion as tdiff
    from lgcnhs_tpu_torch.ops.cuda import fusion_serve as fs
    from lgcnhs_tpu_torch.ops.cuda import propagation as prop
    from lgcnhs_tpu_torch.ops.cuda import retrieval as rt
    from lgcnhs_tpu_torch.ops.topk import MASK_VALUE
    from lgcnhs_tpu_torch.runtime.table import as_str, read_table
    from lgcnhs_tpu_torch.train.trainer import load_checkpoint
    from lgcnhs_tpu_torch.data.raw_standins import write_douban, write_ml100k, write_ml1m

    kernels = {"dual_matmul": prop.dual_matmul, "fused_topk_retrieval": rt.fused_topk_retrieval,
               "fused_lgcnhs_serve": fs.fused_lgcnhs_serve}
    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_ingest_", dir=os.path.join(ROOT, "artifacts"))
    out = {"launches": dict.fromkeys([*kernels, CHUNKED], 0), "ingest": [], "runs": []}
    modules = {"movielens": tml, "movielens1m": tm1, "douban": tdb}
    parts = {
        "parse": [(tml, "read_movielens_raw"), (tm1, "read_movielens1m_raw"),
                  (tdb, "read_table")],
        "ratings": [(m, "prepare_ratings") for m in modules.values()],
        "features": [(tml, "movielens_user_features"), (tml, "movielens_item_features"),
                     (tm1, "ml1m_user_features"), (tm1, "ml1m_item_features"),
                     (tdb, "douban_user_features"), (tdb, "douban_item_features")],
        "align_and_feature_csvs": [(m, "align_and_save") for m in modules.values()],
        "word2vec_plan": [(tw, "plan")],
        "word2vec": [(tw, "train_word2vec")],
    }
    paths_of = {"movielens": ml100k_paths, "movielens1m": ml1m_paths, "douban": douban_paths}
    prepare = {"movielens": tml.prepare_movielens, "movielens1m": tm1.prepare_movielens1m,
               "douban": tdb.prepare_douban}

    def run_of(args):
        """(dataset, data dir, workdir) of a cli run's arguments."""
        return tuple(args[args.index(flag) + 1]
                     for flag in ("--dataset", "--data-dir", "--workdir"))

    def cfg_for(dataset, data_dir, workdir, model="LightGCNOpti"):
        return tcfg.load_config(env="prod", dataset=dataset, model=model, workdir=workdir,
                                overrides={"preprocessing.dataset_paths": paths_of[dataset](
                                    data_dir), "hparams.epochs": INGEST_EPOCHS})

    def same_splits(a, b):
        return a.uid_mapping == b.uid_mapping and a.iid_mapping == b.iid_mapping and all(
            list(getattr(a, s)) == list(getattr(b, s)) and all(
                np.array_equal(getattr(a, s)[c], getattr(b, s)[c]) for c in getattr(a, s))
            for s in ("rating", "train", "val", "test"))

    def ingest(label, dataset, data_dir):
        """The pipeline on the card, timed by part, then on the CPU with its
        text columns marked NaN: splits, mappings and the other feature
        columns identical, the card's text columns finite and trained."""
        cfg = cfg_for(dataset, data_dir, os.path.join(work, label))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with PartTimer(parts) as timer:
            splits, uf, itf = prepare[dataset](cfg, cfg.preprocess_path, dev)
        total = time.perf_counter() - t0
        row = {"run": label, "host_s": total, **timer.row(), "n_users": splits.n_users,
               "n_items": splits.n_items, "n_ratings": len(splits.rating["user_id"])}
        out["ingest"].append(row)
        print(f"[phase 8] ingest {label}: {json.dumps(row)} [{smi}]", flush=True)
        saved = modules[dataset].text_embeddings
        modules[dataset].text_embeddings = (
            lambda docs, dim, *a, **kw: np.full((len(docs), dim), np.nan, np.float32))
        try:
            splits_h, uf_h, itf_h = prepare[dataset](cfg, None, "cpu")
        finally:
            modules[dataset].text_embeddings = saved
        text_u, text_i = np.isnan(uf_h).any(axis=0), np.isnan(itf_h).any(axis=0)
        check(f"ingest {label}: splits and id mappings on the card identical to the CPU's",
              same_splits(splits, splits_h))
        check(f"ingest {label}: non-text features identical to the CPU's, text trained",
              np.array_equal(uf[:, ~text_u], uf_h[:, ~text_u])
              and np.array_equal(itf[:, ~text_i], itf_h[:, ~text_i])
              and bool(np.isfinite(uf).all() and np.isfinite(itf).all())
              and bool(np.abs(itf[:, text_i]).sum() > 0),
              f"user {uf.shape}, item {itf.shape}, text columns {int(text_u.sum())} user, "
              f"{int(text_i.sum())} item")
        return splits

    def w2v_check(label, texts, dim):
        """Card vs CPU word2vec with one injected negative stream; and two
        card runs with the card's own draws bitwise equal."""
        docs = [tf.preprocess_text(t) for t in texts]
        p = tw.plan(docs, dim)
        if p.n_steps == 0:
            return
        gen = torch.Generator(device=dev).manual_seed(SEED)
        noise = torch.from_numpy(p.freq ** 0.75).to(dev, torch.float32)
        negs = torch.multinomial(noise, p.n_steps * 1024 * 5, replacement=True,
                                 generator=gen).view(p.n_steps, 1024, 5).cpu().numpy()
        card = tw.train_word2vec(docs, dim, device=dev, negatives=negs)
        cpu = tw.train_word2vec(docs, dim, device="cpu", negatives=negs)
        gap = float(np.abs(card.vectors - cpu.vectors).max())
        again = [tw.train_word2vec(docs, dim, device=dev).vectors for _ in range(2)]
        check(f"word2vec {label} ({p.n_steps} steps, V={len(p.vocab)}, dim {dim}): the card "
              f"within {W2V_ATOL} of the CPU under one negative stream",
              gap <= W2V_ATOL, f"max gap {gap:.3e}, vectors up to "
              f"{float(np.abs(cpu.vectors).max()):.4f}")
        check(f"word2vec {label}: two card runs with the card's own draws bitwise equal",
              np.array_equal(*again))
        out.setdefault("w2v_gaps", {})[label] = gap

    def ref64(model, cfg, g):
        """(U, I) f64 scores on the card: masked layer-0 scores, or the
        fused G * F."""
        seen = torch.from_numpy(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val)).to(dev)
        params = load_checkpoint(checkpoint_path(cfg), dev)
        ue, ie = params.user_emb.double(), params.item_emb.double()
        G = torch.where(seen, torch.full((g.n_users, g.n_items), MASK_VALUE, dtype=torch.float64,
                                         device=dev), ue @ ie.T)
        if model == "LightGCNOpti":
            return G
        A = torch.from_numpy(interaction_matrix(g.n_users, g.n_items, g.train, g.val,
                                                dtype=np.float64)).to(dev)
        F = tdiff.diffusion_scores(A, torch.tensor(cfg.hparams.lambda_,
                                                   dtype=torch.float32).double())
        return F * G

    log_lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            log_lines.append(record.getMessage())

    keep = Keep(logging.INFO)
    logging.getLogger("lgcnhs").addHandler(keep)

    def counted_run(run):
        """run() with its launches counted (``count_launches``), added to
        the phase's."""
        result, counted = count_launches(kernels, run)
        for name, n in counted.items():
            out["launches"][name] += n
        return result, counted

    def main_run(label, model, args, want, g, target=None):
        """cli/main on the card, its launches counted (``counted_run``);
        Step 1-3 seconds; the list and metrics held against the CPU."""
        clock.marks.clear()
        log_lines.clear()
        torch.cuda.reset_peak_memory_stats()
        t_wall, t0 = time.time(), time.perf_counter()
        extra = ["--target-user", str(target)] if target is not None else []
        want = {**want, CHUNKED: False}  # these graphs fit the dense budget: no chunks
        metrics, counted = counted_run(
            lambda: cli_main.main(["--device", "cuda", "--model", model, *args, *extra]))
        host_s = time.perf_counter() - t0
        m = clock.marks
        row = {"run": label, "host_s": host_s, "step1_s": m["step2"] - t_wall,
               "step2_s": m["step3"] - m["step2"], "step3_s": m["end"] - m["step3"],
               "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counted,
               "metrics": metrics}
        out["runs"].append(row)
        print(f"[phase 8] cli/main {label}: {json.dumps(row)} [{smi}]", flush=True)
        check(f"cli/main {label}: launches {want}",
              all((counted[k] > 0) == v for k, v in want.items()), f"{counted}")
        cfg = cfg_for(*run_of(args), model=model)
        rec = np.load(os.path.join(cfg.recommend_path, f"all_user_recommend_{model}_{cfg.k}.npy"))
        want_rec = recommend(g, cfg, "cpu")
        agreement, gap = tie_equivalence(torch, torch.from_numpy(want_rec).to(dev),
                                         torch.from_numpy(rec).to(dev), ref64(model, cfg, g))
        check(f"cli/main {label}: the list identical to the CPU run's, or tie-equivalent "
              "under f64", agreement == 1.0 or (agreement >= AGREEMENT_MIN and gap <= GAP_MAX),
              f"agreement {agreement:.6f}, gap {gap:.3e}")
        ctx_card = tev.EvalContext.build(g.n_users, g.n_items, g.test, g.train, g.val, dev)
        ctx_cpu = tev.EvalContext.build(g.n_users, g.n_items, g.test, g.train, g.val, "cpu")
        bad = metrics_disagree(metrics, unrounded(ctx_card, rec, False),
                               unrounded(ctx_cpu, rec, False))
        check(f"cli/main {label}: metrics equal the CPU's", not bad, f"disagree on {bad}")
        return rec

    try:
        # (a) ML-100K at the distribution's size
        t0 = time.perf_counter()
        d_a = write_ml100k(os.path.join(work, "ml-100k"), seed=SEED)
        print(f"[phase 8] (a) wrote ML-100K in {time.perf_counter() - t0:.2f} s", flush=True)
        check("native graph builder built on this machine", native.available())
        parsed = native.parse_rating_rows(d_a["rating"], "\t")
        ref = read_table(d_a["rating"], sep="\t", names=["u", "i", "r", "t"])
        check("native parse of u.data equals the reader's",
              parsed is not None and all(np.array_equal(p, ref[c])
                                         for p, c in zip(parsed, ref)))
        data_a = os.path.dirname(d_a["rating"])
        splits_a = ingest("ml100k", "movielens", data_a)
        titles = as_str(read_table(d_a["items"], sep="|", encoding="iso-8859-1",
                                   names=tml.ITEM_COLUMNS)["movie_title"])
        w2v_check("ml100k titles", titles, 5)
        g_a = build_graph(splits_a)
        args_a = ["--dataset", "movielens", "--data-dir", data_a, "--env", "prod",
                  "--epochs", str(INGEST_EPOCHS), "--workdir", os.path.join(work, "wa")]
        raw_user = list(splits_a.uid_mapping)[5]
        rec = main_run("ml100k LightGCNOpti (trains)", "LightGCNOpti", args_a,
                       {"dual_matmul": True, "fused_topk_retrieval": True,
                        "fused_lgcnhs_serve": False}, g_a, target=raw_user)
        mapper = IdMapper.from_splits(splits_a)
        line = (f"recommendations for user {raw_user} (internal 5): internal "
                f"{rec[5].tolist()}, raw {[mapper.internal_to_iid[i] for i in rec[5]]}")
        check("cli/main --target-user by raw id logs the decoded list", line in log_lines)
        main_run("ml100k SpreadLightGCNOpti", "SpreadLightGCNOpti", args_a,
                 dict.fromkeys(kernels, False), g_a)
        t0 = time.perf_counter()
        served, counted = counted_run(lambda: retrieve.main(
            ["--device", "cuda", "--model", "SpreadLightGCNOpti", "--decode", *args_a]))
        out["runs"].append({"run": "ml100k cli/retrieve --decode SpreadLightGCNOpti",
                            "host_s": time.perf_counter() - t0, "launches": counted})
        check("cli/retrieve --decode SpreadLightGCNOpti served through fused_lgcnhs_serve",
              counted == {"dual_matmul": 0, "fused_topk_retrieval": 0, "fused_lgcnhs_serve": 1,
                          CHUNKED: 0},
              f"{counted}")
        cfg_s = cfg_for(*run_of(args_a), model="SpreadLightGCNOpti")
        with open(os.path.join(cfg_s.recommend_path,
                               f"retrieval_SpreadLightGCNOpti_{cfg_s.k}.json")) as f:
            decoded = json.load(f)
        check("cli/retrieve --decode writes every user's list in raw ids",
              decoded == {str(mapper.internal_to_uid[u]): [str(mapper.internal_to_iid[i])
                                                           for i in served[u]]
                          for u in range(g_a.n_users)})
        from lgcnhs_tpu_torch.models.fusion import serve_fused
        plain = serve_fused(g_a, cfg_s, load_checkpoint(checkpoint_path(cfg_s), dev),
                            exact=True)
        agreement, gap = tie_equivalence(torch, torch.from_numpy(plain).to(dev),
                                         torch.from_numpy(served).to(dev),
                                         ref64("SpreadLightGCNOpti", cfg_s, g_a))
        check("cli/retrieve SpreadLightGCNOpti on ML-100K: tie-equivalent to the plain chain",
              agreement >= AGREEMENT_MIN and gap <= GAP_MAX,
              f"agreement {agreement:.6f}, gap {gap:.3e}")

        # (b) ML-1M: phase 4's stand-in written as .dat files
        cfg_syn = tcfg.load_config(env="prod", dataset="movielens1m", model="LightGCNOpti",
                                   workdir=os.path.join(work, "syn"))
        table = synthesize_movielens_like(cfg_syn.synthetic_users, cfg_syn.synthetic_items,
                                          cfg_syn.synthetic_interactions,
                                          seed=cfg_syn.preprocessing.seed)
        t0 = time.perf_counter()
        d_b = write_ml1m(os.path.join(work, "ml-1m"), table, seed=SEED)
        print(f"[phase 8] (b) wrote ML-1M ({len(table['user'])} ratings) in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        native_calls = []
        parse = native.parse_rating_rows
        native.parse_rating_rows = lambda *a: native_calls.append(a) or parse(*a)
        try:
            splits_b = ingest("ml1m", "movielens1m", os.path.dirname(d_b["rating"]))
        finally:
            native.parse_rating_rows = parse
        check("ML-1M ratings.dat parsed by the native library (card and CPU ingestion)",
              len(native_calls) == 2, f"{len(native_calls)} calls")
        check("ML-1M splits from the raw files identical to the synthetic tier's",
              same_splits(splits_b, load_dataset(cfg_syn, dev)[0]))
        args_b = ["--dataset", "movielens1m", "--data-dir", os.path.dirname(d_b["rating"]),
                  "--env", "prod", "--epochs", str(INGEST_EPOCHS),
                  "--workdir", os.path.join(work, "wb")]
        main_run("ml1m LightGCNOpti (trains)", "LightGCNOpti", args_b,
                 {"dual_matmul": True, "fused_topk_retrieval": True, "fused_lgcnhs_serve": False},
                 build_graph(splits_b))

        # (c) Douban with long storylines
        t0 = time.perf_counter()
        d_c = write_douban(os.path.join(work, "douban"), **DOUBAN_SIZE, seed=SEED)
        print(f"[phase 8] (c) wrote Douban {DOUBAN_SIZE} in {time.perf_counter() - t0:.2f} s",
              flush=True)
        data_c = os.path.dirname(d_c["rating"])
        splits_c = ingest("douban", "douban", data_c)
        movies = read_table(d_c["items"])
        w2v_check("douban names", as_str(movies["NAME"]), 3)
        w2v_check(f"douban storylines (first {W2V_STORY_DOCS} movies)",
                  as_str(movies["STORYLINE"])[:W2V_STORY_DOCS], 20)
        args_c = ["--dataset", "douban", "--data-dir", data_c, "--env", "prod",
                  "--epochs", str(INGEST_EPOCHS), "--workdir", os.path.join(work, "wc")]
        main_run("douban LightGCNOpti (trains)", "LightGCNOpti", args_c,
                 {"dual_matmul": True, "fused_topk_retrieval": True, "fused_lgcnhs_serve": False},
                 build_graph(splits_c))
    finally:
        logging.getLogger("lgcnhs").removeHandler(keep)
        shutil.rmtree(work, ignore_errors=True)
    return out


def trace_summary(trace_dir):
    """(trace files, events, events by category, card kernel names, MB) of a
    ``--profile`` directory; events only when it holds one file."""
    files = [n for n in os.listdir(trace_dir) if n.endswith(".pt.trace.json")]
    events, mb = [], 0.0
    if len(files) == 1:
        path = os.path.join(trace_dir, files[0])
        mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    cats, card_kernels = {}, set()
    for e in events:
        cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
        if e.get("cat") == "kernel":
            card_kernels.add(e.get("name", "")[:60])
    return files, len(events), cats, sorted(card_kernels), mb


def cli_child():
    """Phase 11 (b) and (c) in a fresh process, as a user runs the CLIs:
    ``python -c "import chip_smoke; chip_smoke.cli_child()" ARGV TRACE_DIR
    PARITY_WORKDIR`` runs ``cli/main`` with the JSON list ARGV without, with
    (``--profile TRACE_DIR``) and again without ``--profile``, then
    ``cli/parity_report`` (ARGV begins with ``--device``, which both take),
    and prints one JSON line last: each run's metrics,
    launches (``count_site_launches``) and host seconds, and the report's
    return."""
    from lgcnhs_tpu_torch.cli import main as cli_main
    from lgcnhs_tpu_torch.cli import parity_report
    from lgcnhs_tpu_torch.ops.cuda import fusion_serve as fs
    from lgcnhs_tpu_torch.ops.cuda import propagation as prop
    from lgcnhs_tpu_torch.ops.cuda import retrieval as rt

    argv, trace_dir, parity_work = json.loads(sys.argv[1]), sys.argv[2], sys.argv[3]
    kernels = {"fused_topk_retrieval": rt.fused_topk_retrieval,
               "fused_lgcnhs_serve": fs.fused_lgcnhs_serve, "dual_matmul": prop.dual_matmul}
    runs = []
    for extra in ([], ["--profile", trace_dir], []):
        t0 = time.perf_counter()
        # the metrics are host floats: the card has finished the run
        metrics, got = count_site_launches(kernels, lambda: cli_main.main(argv + extra))
        runs.append({"metrics": metrics, "launches": got, "s": time.perf_counter() - t0})
    report = parity_report.main([*argv[:2], "--dataset", "movielens1m", "--env", "prod",
                                 "--workdir", parity_work])
    print(json.dumps({"runs": runs, "parity_report": report}))


def bench_phase(check, smi):
    """Phase 12: ``bench_torch.py`` in a fresh process (module docstring).
    Returns its launches by kernel, its seconds and its record."""
    import torch

    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="bench_torch_", dir=os.path.join(ROOT, "artifacts"))
    try:
        torch.cuda.empty_cache()  # the bench's rows hold up to ~5 GB
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench_torch.py"), "--out-dir", out_dir],
            cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
        secs = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        check("phase 12: bench_torch.py exits 0 and prints its line",
              proc.returncode == 0 and bool(lines),
              f"rc {proc.returncode}; {secs:.1f} s"
              + (f"; {proc.stderr[-3000:]}" if proc.returncode else ""))
        if not lines:
            return None
        print(f"[phase 12] {lines[-1]}", flush=True)
        rec = json.loads(lines[-1])
        extra = rec["extra"]
        check("phase 12: the line's metric is lightgcn_train_examples_per_sec_ml1m, value > 0",
              rec["metric"] == "lightgcn_train_examples_per_sec_ml1m" and rec["value"] > 0,
              f"{rec['metric']} {rec['value']} {rec['unit']}")
        check("phase 12: kernel_contracts pass", extra.get("kernel_contracts") == "pass",
              f"{extra.get('kernel_contracts')}")
        check("phase 12: no row_errors", "row_errors" not in extra,
              f"{extra.get('row_errors')}")
        check("phase 12: the headline's trace matched its dual_matmul launches",
              extra.get("headline_launch_check") == "matched",
              f"{extra.get('headline_launch_check')}")
        with open(os.path.join(out_dir, "bench_torch_stats.json")) as f:
            side = json.load(f)
        launches = side["run"]["launches"]
        for name, n in launches.items():
            check(f"phase 12: the bench launched {name}", n > 0, f"{n} launches")
        rows = {name: {"s": row["s"], "peak_gb": row.get("peak_gb")}
                for name, row in side["rows"].items()}
        print(f"[phase 12] rows {json.dumps(rows)}", flush=True)
        print(f"[phase 12] stats {json.dumps(side['stats'])}", flush=True)
        print(f"[phase 12] the CPU baseline's row: {rows['train_cpu_baseline']['s']:.1f} s "
              f"of {secs:.1f} s [{smi}]", flush=True)
        return {"launches": launches, "s": secs, "record": rec}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def experimental_phase(check, dev, smi, env):
    """Phase 11: the experimental autoencoders at ML-100K, ``cli/main
    --profile`` on phase 4's trained checkpoint and ``cli/parity_report``
    (module docstring). Returns its launches by kernel and call site and its
    rows."""
    import numpy as np
    import torch

    from lgcnhs_tpu_torch import config as tcfg
    from lgcnhs_tpu_torch.cli.common import load_pipeline
    from lgcnhs_tpu_torch.data.fetch import ml100k_paths
    from lgcnhs_tpu_torch.data.graph import interaction_matrix
    from lgcnhs_tpu_torch.data.raw_standins import write_ml100k
    from lgcnhs_tpu_torch.models import experimental as ex
    from lgcnhs_tpu_torch.ops import diffusion as tdiff
    from lgcnhs_tpu_torch.ops.topk import MASK_VALUE, masked_topk

    kernels = env["kernels"]
    launches = dict.fromkeys([*kernels, CHUNKED, DISTRIBUTED], 0)
    rows = []
    no_kernel = dict.fromkeys(launches, 0)

    def add(got):
        for name, n in got.items():
            launches[name] += n

    def counted(fn):
        """(fn(), its launches, its host seconds), the launches added to
        phase 11's."""
        t0 = time.perf_counter()
        out, got = count_site_launches(kernels, fn)
        torch.cuda.synchronize()
        add(got)
        return out, got, time.perf_counter() - t0

    def row(name, **values):
        rows.append({"name": name, **values})
        print(f"[phase 11] {name}: {json.dumps(values)} [{smi}]", flush=True)

    work = tempfile.mkdtemp(prefix="chip_smoke_experimental_",
                            dir=os.path.join(ROOT, "artifacts"))
    try:
        # (a) the autoencoders on the ML-100K stand-in, its own features
        data_dir = os.path.join(work, "ml-100k")
        write_ml100k(data_dir)
        cfg = tcfg.load_config(env="prod", dataset="movielens", workdir=work, overrides={
            "preprocessing.dataset_paths": ml100k_paths(data_dir)})
        cfg.ensure_dirs()
        graph, uf, itf, _ = load_pipeline(cfg, dev)
        U, I = graph.n_users, graph.n_items
        R = interaction_matrix(U, I, graph.train)
        width = max(uf.shape[1], itf.shape[1])
        init = ex.init_autoencoder(torch.Generator().manual_seed(SEED), width, AE_HIDDEN)
        print(f"[phase 11] autoencoders: {U} x {I} train incidence ({graph.train.n_edges} "
              f"edges), joint adjacency {U + I}^2, features {uf.shape[1]} / {itf.shape[1]} "
              f"padded to {width}, hidden {AE_HIDDEN}, {AE_EPOCHS} epochs", flush=True)
        trained = {}
        for kind in ex.KINDS:
            runs = {}
            for where, device in (("the card", dev), ("the CPU", "cpu")):
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()  # by the earlier phases
                out, got, secs = counted(lambda: ex.train_autoencoder(
                    R, uf, itf, hidden_dim=AE_HIDDEN, epochs=AE_EPOCHS, kind=kind, init=init,
                    device=device))
                runs[where] = (out, secs, (torch.cuda.max_memory_allocated() - held) / 1e9)
                check(f"train_autoencoder {kind} on {where}: no hand kernel launched",
                      got == no_kernel, f"{got}")
            (pc, hc), card_s, peak = runs["the card"]
            (pp, hp), cpu_s, _ = runs["the CPU"]
            hist_gap = max(abs(a - b) / abs(b) for a, b in zip(hc, hp))
            param_gap = max(((a.cpu() - b).abs().max() / b.abs().max()).item()
                            for a, b in zip(pc, pp))
            check(f"train_autoencoder {kind}: the card's history within {AE_HISTORY_RTOL:g} "
                  "relative of the CPU's at every epoch, falling, finite",
                  len(hc) == AE_EPOCHS and hist_gap <= AE_HISTORY_RTOL
                  and all(math.isfinite(v) for v in hc) and hc[-1] < hc[0],
                  f"max gap {hist_gap:.3e}; loss {hc[0]:.6f} -> {hc[-1]:.6f}")
            check(f"train_autoencoder {kind}: the card's parameters within {AE_PARAM_TOL:g} "
                  "of scale of the CPU's", param_gap <= AE_PARAM_TOL, f"{param_gap:.3e}")
            row(f"train_autoencoder {kind}", shape=f"{U}x{I}", epochs=AE_EPOCHS,
                card_ms_per_epoch=card_s * 1e3 / AE_EPOCHS,
                cpu_ms_per_epoch=cpu_s * 1e3 / AE_EPOCHS, peak_device_gb=peak,
                history_max_rel_gap=hist_gap, param_max_rel_gap=param_gap,
                loss_first_last=[hc[0], hc[-1]])
            trained[kind] = pc

        # hybrid_gat_fusion on the card's GAT parameters, on the card and on
        # the CPU, lists read against the f64 fused scores
        params = trained["gat"]
        fused_card, got_f, fuse_s = counted(
            lambda: ex.hybrid_gat_fusion(params, R, uf, itf, AE_LAMBDA))
        fused_cpu = ex.hybrid_gat_fusion(ex.MLPGraphParams(*(t.cpu() for t in params)),
                                         R, uf, itf, AE_LAMBDA)
        check("hybrid_gat_fusion on the card: no hand kernel launched", got_f == no_kernel,
              f"{got_f}")
        seen = torch.from_numpy(R > 0).to(dev)
        Xu = np.pad(uf, ((0, 0), (0, width - uf.shape[1])))
        Xi = np.pad(itf, ((0, 0), (0, width - itf.shape[1])))
        X64 = torch.from_numpy(np.vstack([Xu, Xi]).astype(np.float32)).to(dev).double()
        R64 = torch.from_numpy(R).to(dev).double()
        p64 = ex.MLPGraphParams(*(t.double() for t in params))
        Zu, Zi = ex.gat_autoencoder_forward(p64, R64, X64[:U], X64[U:])
        ref = (Zu @ Zi.T) * tdiff.diffusion_scores(R64, torch.tensor(AE_LAMBDA,
                                                                      dtype=torch.float64))
        ref.masked_fill_(seen, MASK_VALUE)
        got_ids = masked_topk(fused_card, seen, K_SLICE)
        want_ids = masked_topk(fused_cpu.to(dev), seen, K_SLICE)
        agreement, gap = tie_equivalence(torch, want_ids, got_ids, ref)
        check(f"hybrid_gat_fusion top-{K_SLICE}: the card's lists tie-equivalent to the CPU's",
              agreement >= AGREEMENT_MIN and gap <= GAP_MAX,
              f"agreement {agreement:.6f}, mismatched-slot max relative gap {gap:.3e}")
        row("hybrid_gat_fusion", shape=f"{U}x{I}", k=K_SLICE, card_ms=fuse_s * 1e3,
            agreement=agreement, max_rel_gap=gap)
        del ref, Zu, Zi, R64, X64, seen

        # (b) cli/main --profile on phase 4's trained ML-1M checkpoint, between
        # two runs without it, and (c) cli/parity_report: in a fresh process,
        # as a user runs them
        trace_dir = os.path.join(work, "trace")
        argv = ["--device", dev.type, "--workdir", env["train_work"], "--model", "LightGCNOpti",
                *env["ml1m"], "--no-cache"]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", "import chip_smoke; chip_smoke.cli_child()", json.dumps(argv),
             trace_dir, os.path.join(work, "parity")],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        if not check("cli/main x3 and cli/parity_report in a fresh process: exit 0",
                     proc.returncode == 0, f"rc {proc.returncode}; {child_s:.1f} s host"
                     + (f"; {proc.stderr[-3000:]}" if proc.returncode else "")):
            return None
        result = json.loads(lines[-1])
        (plain, profiled, again) = result["runs"]
        for run in result["runs"]:
            add(run["launches"])
        one = {**no_kernel, "fused_topk_retrieval": 1}
        check("cli/main --profile: the metric line equals the runs without it",
              profiled["metrics"] == plain["metrics"] == again["metrics"],
              f"{profiled['metrics']} against {plain['metrics']}, {again['metrics']}")
        check("cli/main with and without --profile: one fused_topk_retrieval launch each",
              all(run["launches"] == one for run in result["runs"]),
              f"{[run['launches'] for run in result['runs']]}")
        files, n_events, cats, card_kernels, trace_mb = trace_summary(trace_dir)
        fused = [k for k in card_kernels if "fused_topk_kernel" in k]
        check("cli/main --profile: one trace file, holding a CUDA kernel event of "
              "fused_topk_kernel", len(files) == 1 and bool(fused),
              f"files {files}, {n_events} events by category {cats}, {trace_mb:.1f} MB, "
              f"{len(card_kernels)} card kernels, fused {fused}")
        row("cli/main LightGCNOpti movielens1m trained, --profile",
            plain_s=[plain["s"], again["s"]], profiled_s=profiled["s"],
            overhead_s=profiled["s"] - (plain["s"] + again["s"]) / 2, trace_events=n_events,
            trace_mb=trace_mb, process_s=child_s)
        check("cli/parity_report on the card: returns and prints {\"reference\": false}",
              result["parity_report"] == {"reference": False}
              and '{"reference": false}' in lines[:-1], f"{result['parity_report']}")

    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"launches": launches, "rows": rows}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a CUDA card",
              file=sys.stderr)
        return 2
    try:
        from lgcnhs_tpu_torch import config as tcfg
        from lgcnhs_tpu_torch.cli import main as cli_main
        from lgcnhs_tpu_torch.cli import retrieve
        from lgcnhs_tpu_torch.data.datasets import load_dataset
        from lgcnhs_tpu_torch.data.graph import (
            build_graph, interaction_matrix, pos_bool_matrix, unique_edges,
        )
        from lgcnhs_tpu_torch.eval import metrics as tev
        from lgcnhs_tpu_torch.models.fusion import allocate_matrix
        from lgcnhs_tpu_torch.models.lightgcn import (
            LightGCNParams, init_lightgcn, init_lightgcn_opti,
        )
        from lgcnhs_tpu_torch.models.recommenders import checkpoint_path, recommend
        from lgcnhs_tpu_torch.models.spread import SPREAD_METHODS, resolve_spread_variant
        from lgcnhs_tpu_torch.ops import diffusion as tdiff
        from lgcnhs_tpu_torch.ops import metrics_ops
        from lgcnhs_tpu_torch.ops.cuda import build
        from lgcnhs_tpu_torch.ops.cuda import fusion_serve as fs
        from lgcnhs_tpu_torch.ops.cuda import propagation as prop
        from lgcnhs_tpu_torch.ops.cuda import retrieval as rt
        from lgcnhs_tpu_torch.ops.diffusion import general_spreading_matrix, hybrid_transfer
        from lgcnhs_tpu_torch.ops.topk import (
            MASK_VALUE, masked_topk, rank_exclude_seen_topk, retrieval_route, select_topk,
        )
        from lgcnhs_tpu_torch.train import trainer
        from lgcnhs_tpu_torch.train.trainer import load_checkpoint, save_checkpoint
    except ImportError as e:
        print(f"chip_smoke: the lgcnhs_tpu_torch package is not beside this script ({e})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    check = Checks()
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # -- 1. environment ---------------------------------------------------
    smi = gpu_name_and_power()
    kind = torch.cuda.get_device_name(0)
    print(f"[env] nvidia-smi: {smi} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| device {kind} x{torch.cuda.device_count()}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    build.build(verbose=True)
    limit = build.device_smem_limit("retrieval", dev)
    print(f"[build] {', '.join(build.SOURCES)} in {time.perf_counter() - t0:.1f} s; "
          f"block shared-memory limit {limit} B", flush=True)

    gen = np.random.default_rng(SEED)

    def cuda(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def dyadic(shape, lo=-4, hi=5):
        return (gen.integers(lo, hi, shape) / 8).astype(np.float32)

    def normal(shape, scale):
        return (gen.standard_normal(shape) * scale).astype(np.float32)

    def sub_sentinel(ue, ie, seen):
        """Users 0 and 1 score below -1024 everywhere; user 1 has seen items,
        which then outrank every unseen one."""
        ie[:, 0] = 1.0 + np.abs(ie[:, 0])
        ue[:2] = 0.0
        ue[:2, 0] = -3000.0
        seen[:2] = False
        seen[1, [5, 17, 250]] = True

    def retrieval_ref64(ue, ie, seen):
        s = ue.double() @ ie.double().T
        return torch.where(seen, torch.full_like(s, MASK_VALUE), s)

    def serve_ref64(ue, ie, A, W, seen):
        """f64 fused scores; F summed over row blocks of W, so no f64 copy of
        all of W is made (9.8 GB in f32 at 49,410 items)."""
        f = torch.zeros((A.shape[0], W.shape[1]), dtype=torch.float64, device=A.device)
        step = max(1, (1 << 28) // W.shape[1])
        for l0 in range(0, W.shape[0], step):
            f += A[:, l0:l0 + step].double() @ W[l0:l0 + step].double()
        f *= ue.double() @ ie.double().T
        return f.masked_fill_(seen, fs.EXCLUDED)

    # -- 3. kernels against their twins ----------------------------------
    def retrieval_checks(U, I, D, ks, label):
        """The retrieval kernel against the twin at each k, dyadic (bitwise)
        and continuous (tie-equivalent), with the sub-sentinel users and a
        second launch bitwise equal to the first."""
        for exact in (True, False):
            ue = dyadic((U, D)) if exact else normal((U, D), 0.3)
            ie = dyadic((I, D)) if exact else normal((I, D), 0.3)
            seen = gen.random((U, I)) < 0.05
            sub_sentinel(ue, ie, seen)
            ue, ie, seen = cuda(ue), cuda(ie), cuda(seen)
            ref = None if exact else retrieval_ref64(ue, ie, seen)
            for k in ks:
                want = rt.fused_topk_retrieval_ref(ue, ie, seen, k)
                got = rt.fused_topk_retrieval(ue, ie, seen, k)
                again = rt.fused_topk_retrieval(ue, ie, seen, k)
                torch.cuda.synchronize()
                flavor = f"retrieval {label} k={k} {'dyadic' if exact else 'continuous'}"
                compare(torch, check, flavor, got, want, ref)
                sub = got[0][:2]
                check(f"{flavor}: sub-sentinel users get real ids",
                      bool(((sub >= 0) & (sub < I)).all())
                      and got[0][1, :3].tolist() == [5, 17, 250][:min(k, 3)])
                check(f"{flavor}: second launch bitwise equal",
                      torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
            del ref

    def list_checks(U, I, D, ks):
        """The retrieval kernel at each k over a catalog that is not a whole
        number of 128-item steps: k = 128 (the largest k merged in
        registers) and 129 (merged through memory), 407 (the largest k whose
        lists fit the block's shared memory) and 408 (running lists in
        device memory), 1000 and 3000 (merge lists in device memory too);
        dyadic, with the sub-sentinel users and a second launch bitwise
        equal to the first."""
        ue, ie = dyadic((U, D)), dyadic((I, D))
        seen = gen.random((U, I)) < 0.05
        sub_sentinel(ue, ie, seen)
        ue, ie, seen = cuda(ue), cuda(ie), cuda(seen)
        for k in ks:
            label = (f"retrieval {U}x{I}x{D} k={k} (workspace "
                     f"{rt.topk_block_bytes(k, limit)[1]} B a block)")
            got = rt.fused_topk_retrieval(ue, ie, seen, k)
            again = rt.fused_topk_retrieval(ue, ie, seen, k)
            torch.cuda.synchronize()
            compare(torch, check, label, got, rt.fused_topk_retrieval_ref(ue, ie, seen, k))
            check(f"{label}: second launch bitwise equal",
                  torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
            sub = got[0][:2]
            check(f"{label}: users scoring below -1024 everywhere get real ids",
                  bool(((sub >= 0) & (sub < I)).all())
                  and got[0][1, :3].tolist() == [5, 17, 250][:min(k, 3)])

    def serve_checks(U, I, D, ks, label, A_real=None):
        """Fused serving against its twin at each k, dyadic and continuous,
        with a second launch bitwise equal to the first; user 0 has three
        unseen items (fewer than k: its seen items follow, lowest id first),
        user 1 none seen (every fused score +-0). W is drawn on the card."""
        wgen = torch.Generator(device=dev).manual_seed(SEED)
        for exact in (True, False):
            ue = dyadic((U, D)) if exact else normal((U, D), 0.3)
            ie = dyadic((I, D)) if exact else normal((I, D), 0.3)
            W = (torch.randint(0, 4, (I, I), generator=wgen, device=dev).float() / 8 if exact
                 else torch.rand((I, I), generator=wgen, device=dev) * 0.01)
            A = A_real if A_real is not None else (gen.random((U, I)) < 0.04).astype(np.float32)
            A = A.copy()
            A[0] = 1.0
            A[0, [3, 50, 121]] = 0.0  # user 0: three unseen items, fewer than k
            A[1] = 0.0  # user 1: no interactions, every fused score is +-0
            ue, ie, A = cuda(ue), cuda(ie), cuda(A)
            seen = A > 0
            ref = None if exact else serve_ref64(ue, ie, A, W, seen)
            tail = [j for j in range(I) if j not in (3, 50, 121)]
            for k in ks:
                flavor = f"fused serve {label} k={k} {'dyadic' if exact else 'continuous'}"
                want = fs.fused_lgcnhs_serve_ref(ue, ie, A, W, seen, k)
                got = fs.fused_lgcnhs_serve(ue, ie, A, W, seen, k)
                again = fs.fused_lgcnhs_serve(ue, ie, A, W, seen, k)
                torch.cuda.synchronize()
                compare(torch, check, flavor, got, want, ref)
                check(f"{flavor}: second launch bitwise equal",
                      torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]))
                row = got[0][0].tolist()
                check(f"{flavor}: fewer-than-k-unseen user gets distinct ids, its seen items "
                      "lowest id first",
                      len(set(row)) == k and set(row[:3]) == {3, 50, 121}.intersection(row[:3])
                      and len(set(row[:3])) == min(k, 3) and row[3:] == tail[:max(0, k - 3)],
                      f"{row[:6]}")
                check(f"{flavor}: user with no interactions scores +-0 as the twin ranks them",
                      bool((got[1][1] == 0).all()) and torch.equal(got[0][1], want[0][1]))
            del W

    def serve_w_bits_checks(U, I, D, ks, label):
        """Fused serving with a W of 20 significant bits, in [0.5, 1): one
        bf16 part of W holds 8 of them, two hold 16, so a kernel that drops
        a part of W is off by up to 2^-8 or 2^-16 of F. A has 12 items a
        user, so each F sum (12 multiples of 2^-20 below 16) is exact in
        f32 in any order, and G*F is identical to the twin's."""
        wgen = torch.Generator(device=dev).manual_seed(SEED + 1)
        W = torch.randint(1 << 19, 1 << 20, (I, I), generator=wgen, device=dev).float() / (1 << 20)
        A = np.zeros((U, I), np.float32)
        np.put_along_axis(A, gen.random((U, I)).argsort(axis=1)[:, :12], 1.0, axis=1)
        ue, ie, A = cuda(dyadic((U, D))), cuda(dyadic((I, D))), cuda(A)
        for k in ks:
            compare(torch, check, f"fused serve {label} k={k} W of 20 significant bits",
                    fs.fused_lgcnhs_serve(ue, ie, A, W, A > 0, k),
                    fs.fused_lgcnhs_serve_ref(ue, ie, A, W, A > 0, k))

    def edge_checks():
        """Ragged shapes: partial user blocks, D off the load batch, k == I,
        I below a warp, k above 128."""
        for U, I, D, k in ((37, 300, 20, 10), (13, 40, 3, 40), (9, 5, 8, 5), (70, 1000, 64, 200)):
            label = f"edge U={U} I={I} D={D} k={k}"
            ue, ie = cuda(dyadic((U, D))), cuda(dyadic((I, D)))
            seen = cuda(gen.random((U, I)) < 0.2)
            want = rt.fused_topk_retrieval_ref(ue, ie, seen, k)
            compare(torch, check, f"retrieval {label}",
                    rt.fused_topk_retrieval(ue, ie, seen, k), want)
            mask = gen.random((U, I)) < 0.2
            A = cuda(mask.astype(np.float32))
            W = cuda(dyadic((I, I), 0, 4))
            compare(torch, check, f"fused serve {label}",
                    fs.fused_lgcnhs_serve(ue, ie, A, W, A > 0, k),
                    fs.fused_lgcnhs_serve_ref(ue, ie, A, W, A > 0, k))
            # an A that is not exact in bf16 (12 significand bits) goes in as
            # three parts; its products and sums are still exact in f32
            A12 = cuda((mask * gen.integers(1, 4096, (U, I)) / 4096).astype(np.float32))
            compare(torch, check, f"fused serve {label} A not exact in bf16",
                    fs.fused_lgcnhs_serve(ue, ie, A12, W, A12 > 0, k),
                    fs.fused_lgcnhs_serve_ref(ue, ie, A12, W, A12 > 0, k))

    def dual_case(label, R, X, Y, exact):
        """dual_matmul against its twin, forward and backward (cotangents
        through torch.autograd.grad), and against a second launch."""
        got, again = prop.dual_matmul(R, X, Y), prop.dual_matmul(R, X, Y)
        want = prop.dual_matmul_ref(R, X, Y)
        torch.cuda.synchronize()
        check(f"dual_matmul {label}: two launches bitwise equal",
              all(torch.equal(a, b) for a, b in zip(got, again)))
        gu, gi = (cuda(dyadic(tuple(t.shape)) if exact else normal(tuple(t.shape), 1.0))
                  for t in want)
        grads = []
        for fn in (prop.dual_matmul, prop.dual_matmul_ref):
            Xg, Yg = X.detach().requires_grad_(True), Y.detach().requires_grad_(True)
            grads.append(torch.autograd.grad(fn(R, Xg, Yg), (Xg, Yg), (gu, gi)))
        torch.cuda.synchronize()
        # a bf16 gradient is an f32 sum rounded to bf16: f32 sums in another
        # order may round one bf16 step (<= 2^-7 of the value) apart
        ulp_bwd = BF16_ULP if X.dtype == torch.bfloat16 else 0.0
        for what, g, w, ulp in (("forward", got, want, 0.0),
                                ("backward", grads[0], grads[1], ulp_bwd)):
            if exact:
                diff = max((a.float() - b.float()).abs().max().item() for a, b in zip(g, w))
                check(f"dual_matmul {label} {what} == twin (bitwise)",
                      all(torch.equal(a, b) for a, b in zip(g, w)), f"max |diff| {diff:.3e}")
                continue
            err = max(((a.float() - b.float()).abs() - ulp * b.float().abs()).max().item()
                      / max(b.float().abs().max().item(), 1e-30) for a, b in zip(g, w))
            check(f"dual_matmul {label} {what} within {DUAL_REL_TOL:g} of the twin's scale",
                  err <= DUAL_REL_TOL, f"max relative error {err:.3e}")

    def dual_checks(R8):
        """The four dtype pairs on the slice's train incidence (float R:
        its pattern with dyadic or normal values), then ragged shapes."""
        U, I = R8.shape
        names = {torch.float32: "f32", torch.bfloat16: "bf16", torch.int8: "int8"}
        for rdt, edt in prop.PAIRS:
            for exact in (True, False):
                vals = dyadic if exact else (lambda shape: normal(shape, 1.0))
                R = R8 if rdt == torch.int8 else (R8.float() * cuda(vals((U, I)))).to(rdt)
                dual_case(f"{U}x{I}x64 {names[rdt]}/{names[edt]} "
                          f"{'dyadic' if exact else 'continuous'}", R,
                          cuda(vals((I, 64))).to(edt), cuda(vals((U, 64))).to(edt), exact)
        # ragged shapes: U, I off the 64-tile and off 16, I below a warp,
        # D 3/20 (bf16 rows not a whole number of 16-byte copies) and 8/64/128;
        # the last, skewed: hot items every user has and a user with every item
        for U2, I2, D2 in ((37, 300, 8), (13, 20, 64), (70, 1000, 128), (500, 31, 64), (1, 1, 8),
                           (130, 333, 3), (200, 1001, 20), (700, 150, 64)):
            mask = gen.random((U2, I2)) < 0.3
            if (U2, I2) == (700, 150):
                mask[:, :5] = True
                mask[3] = True
            mask = cuda(mask)
            for rdt, edt in prop.PAIRS:
                R = mask.to(torch.int8) if rdt == torch.int8 else \
                    (mask.float() * cuda(dyadic((U2, I2)))).to(rdt)
                dual_case(f"edge U={U2} I={I2} D={D2} {names[rdt]}/{names[edt]}", R,
                          cuda(dyadic((I2, D2))).to(edt), cuda(dyadic((U2, D2))).to(edt), True)
        # R as a view of a wider buffer whose entries past column I are junk
        # (NaN for bf16, negative bytes for int8): read in place, never counted
        U2, I2 = 130, 333
        mask = cuda(gen.random((U2, I2)) < 0.3)
        for rdt, junk in ((torch.bfloat16, float("nan")), (torch.int8, -77)):
            R = mask.to(rdt) if rdt == torch.int8 else \
                (mask.float() * cuda(dyadic((U2, I2)))).to(rdt)
            wide = torch.full((U2, 352), junk, dtype=rdt, device=R.device)
            wide[:, :I2] = R
            view = wide[:, :I2]
            Xv, Yv = (cuda(dyadic((n, 20))).to(torch.bfloat16) for n in (I2, U2))
            got, want = prop.dual_matmul(view, Xv, Yv), prop.dual_matmul_ref(R, Xv, Yv)
            torch.cuda.synchronize()
            check(f"dual_matmul {names[rdt]} R view with junk past column I == twin (bitwise)",
                  prop.rows_aligned(view) and all(torch.equal(a, b) for a, b in zip(got, want)))

    print("[phase 3] kernels against their twins", flush=True)
    check.guard("edge shapes", edge_checks)
    ds_cfg = tcfg.load_config(env="prod", dataset="movielens1m", model="LightGCNOpti")
    splits, feats_u, feats_i = load_dataset(ds_cfg)
    graph = build_graph(splits)
    R8_slice, du_slice, di_slice = trainer.device_binary_factors(
        graph.n_users, graph.n_items, graph.train, dev)
    A_slice = interaction_matrix(graph.n_users, graph.n_items, graph.train, graph.val)
    tlib = rt._topk_launcher()[0]
    mism = [(k, rt.topk_block_bytes(k, limit),
             (tlib.fused_topk_smem_bytes(k, limit), tlib.fused_topk_workspace_bytes(k, limit)))
            for k in (1, 100, 128, 129, 146, 147, 407, 408, 1000, 3000)]
    mism = [x for x in mism if tuple(x[1]) != tuple(x[2])]
    check("retrieval guard: topk_block_bytes equals the launcher's shared memory and workspace",
          not mism, f"{mism}")
    resident = {k: tlib.fused_topk_resident_blocks(k, limit) for k in (1, 100, 147)}
    check("retrieval kernel: two blocks (16 warps) an SM at k=100, as shared memory allows",
          resident[100] == 2 and resident[147] == 1, f"resident blocks {resident}")
    check("route: the kernel for float32 tables, the plain chain for float64",
          [retrieval_route("cuda", t) for t in (torch.float32, torch.float64)]
          == ["kernel", "plain"])
    check("dual_matmul guard: D=64 and D=128 fit, D=129 does not",
          prop.fits_smem_dual(64, limit) and prop.fits_smem_dual(128, limit)
          and not prop.fits_smem_dual(129, limit) and prop.fits_dual(64, dev)
          and prop.fits_dual(128, dev) and not prop.fits_dual(129, dev))
    plib = build.load_library("propagation")
    smem_pairs = [(r, e, d) for r, e in prop.PAIRS for d in (3, 20, 64, 128)]
    mism = [(str(r), str(e), d, prop.smem_bytes(d, r, e),
             plib.dual_matmul_smem_bytes(prop._CODES[r], prop._CODES[e], d))
            for r, e, d in smem_pairs
            if prop.smem_bytes(d, r, e) != plib.dual_matmul_smem_bytes(prop._CODES[r],
                                                                        prop._CODES[e], d)]
    check("dual_matmul guard: smem_bytes equals the launcher's shared memory", not mism,
          f"{mism}")
    slib = fs._launcher()[0]
    sizes = [(k, na, fs.serve_block_bytes(k, na, limit),
              (slib.fused_serve_smem_bytes(k, na, limit),
               slib.fused_serve_workspace_bytes(k, na, limit)))
             for k in (1, 100, 108, 109, 1000, 1816, 1817, 3000) for na in (1, 3)]
    mism = [x for x in sizes if tuple(x[2]) != tuple(x[3])]
    check("fused serve: serve_block_bytes equals the launcher's shared memory and workspace",
          not mism, f"{mism}")
    xs = torch.cat([torch.randn((300, 1000), device=dev) * 1e3,
                    torch.rand((300, 1000), device=dev) * 1e-20])
    binary = (torch.rand((300, 1000), device=dev) < 0.3).float()
    for x0, n, tr in ((xs, 1, False), (xs, 3, False), (xs, 3, True), (binary, 1, False)):
        x = x0.T if tr else x0
        flag = torch.zeros(1, dtype=torch.int32, device=dev) if n == 1 else None
        on_card = fs.split_on_card(x0, n, 608 if tr else 1008, transpose=tr, inexact=flag)
        plain = fs.bf16_parts(x, n, 608 if tr else 1008)
        back = on_card.float().sum(0)[:, :x.shape[1]] if n == 3 else None
        what = "a 0/1 matrix" if x0 is binary else "x^T" if tr else "x"
        check(f"bf16 split ({n} part{'s' if n > 1 else ''} of {what}) on the "
              "card == its plain version (bitwise)"
              + (", and sums back to the input" if n == 3 else
                 f", flagged {'exact' if x0 is binary else 'not exact'} in bf16"),
              torch.equal(on_card, plain) and (back is None or torch.equal(back, x))
              and (flag is None or int(flag) == int(x0 is not binary)))
    check.guard("dual_matmul", dual_checks, R8_slice)
    check.guard("retrieval 384x896", retrieval_checks, 384, 896, 64, (10, 100), "384x896")
    check.guard("retrieval ML-100K shape", retrieval_checks, 943, 1682, 64, (1, 100, 1000),
                "943x1682x64")
    check.guard("retrieval slice", retrieval_checks, graph.n_users, graph.n_items, 64,
                (1, 100, 1000), f"{graph.n_users}x{graph.n_items}x64")
    check.guard("retrieval 50k", retrieval_checks, 384, BIG_CATALOG, 64, (100, 1000),
                f"384x{BIG_CATALOG}")
    check.guard("retrieval lists", list_checks, 300, 1111, 64, (1, 128, 129, 407, 408, 1000))
    check.guard("retrieval k=3000", list_checks, 40, 3500, 16, (3000,))
    check.guard("retrieval D=1024", retrieval_checks, 128, 16_384, 1024, (100,),
                "128x16384 D=1024")
    check.guard("serve 384x896", serve_checks, 384, 896, 64, (10, 100), "384x896")
    check.guard("serve slice", serve_checks, graph.n_users, graph.n_items, 64, (10, 100),
                f"{graph.n_users}x{graph.n_items}x64", A_slice)
    check.guard("serve past the earlier cap", serve_checks, 384, 20_000, 64, (1, 100, 1000),
                "384x20000")
    check.guard("serve W of 20 bits", serve_w_bits_checks, 384, 896, 64, (10, 100), "384x896")
    check.guard("serve W of 20 bits, slice", serve_w_bits_checks, graph.n_users, graph.n_items,
                64, (100,), f"{graph.n_users}x{graph.n_items}x64")
    del A_slice

    # -- 4. the serving slice end to end ----------------------------------
    print("[phase 4] cli/retrieve end to end", flush=True)
    os.makedirs(os.path.join(ROOT, "artifacts"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT, "artifacts"))
    ml1m = ["--dataset", "movielens1m", "--env", "prod"]
    big = ["--dataset", "synthetic", "--env", "prod", "--users", "6040",
           "--items", str(BIG_CATALOG), "--interactions", "1000209"]
    # (model, arguments, k): k=100 is the prod preset's; a list of 1000 over
    # the large catalog keeps its running lists in device memory
    runs = [("SpreadLightGCNOpti", ml1m, K_SLICE), ("LightGCNOpti", ml1m, K_SLICE),
            ("LightGCNOpti", big, K_SLICE), ("SpreadLightGCNOpti", big, K_SLICE),
            ("LightGCNOpti", big, K_LARGE)]

    def run_config(model, args, workdir, k=K_SLICE):
        """The config a CLI run with these arguments resolves."""
        over = {"k": k}
        if args is big:
            over.update(synthetic_users=6040, synthetic_items=BIG_CATALOG,
                        synthetic_interactions=1_000_209)
        return tcfg.load_config(env="prod", dataset=args[1], model=model, workdir=workdir,
                                overrides=over)

    def make_cell(model, args, k, workdir, dtype=torch.float32):
        """(config, graph, seeded random tables) of one run, its checkpoint
        written where cli/retrieve looks for it."""
        cfg = run_config(model, args, workdir, k)
        splits, uf, itf = load_dataset(cfg)
        g = build_graph(splits)
        params = init_lightgcn_opti(torch.Generator().manual_seed(SEED), uf, itf, 64)
        params = LightGCNParams(*(t.to(dtype) for t in params))
        os.makedirs(cfg.model_path, exist_ok=True)
        save_checkpoint(checkpoint_path(cfg), params)
        return cfg, g, params

    cells = {(model, args[1], k): make_cell(model, args, k, work) for model, args, k in runs}

    kernels = {"fused_topk_retrieval": rt.fused_topk_retrieval,
               "fused_lgcnhs_serve": fs.fused_lgcnhs_serve}
    for fn in kernels.values():
        fn.launches = 0
        fn.merge_launches = 0
    fs.fused_lgcnhs_serve.split_launches = 0
    outputs, run_launches = [], []
    for model, args, k in runs:
        t0 = time.perf_counter()
        before = {name: fn.launches for name, fn in kernels.items()}
        rec = retrieve.main(["--device", "cuda", "--workdir", work, "--model", model, *args,
                             "--k", str(k)])
        outputs.append(rec)
        run_launches.append({name: fn.launches - before[name] for name, fn in kernels.items()})
        print(f"[phase 4] {model} {args[1]} k={k}: {rec.shape} in "
              f"{time.perf_counter() - t0:.2f} s, launches {run_launches[-1]}", flush=True)
    launches = {name: fn.launches for name, fn in kernels.items()}
    merges = {name: fn.merge_launches for name, fn in kernels.items()}
    serve_splits = fs.fused_lgcnhs_serve.split_launches
    print(f"[phase 4] launches {launches}, merges {merges}, fused serve split {serve_splits}",
          flush=True)
    for name, n in launches.items():
        check(f"main path launched {name}", n > 0, f"{n} launches")
    check("main path launched the retrieval kernel's merge over its catalog parts with each "
          "call", merges["fused_topk_retrieval"] == launches["fused_topk_retrieval"], f"{merges}")
    check("main path launched the fused serve's merge and its bf16 split with each call",
          merges["fused_lgcnhs_serve"] == launches["fused_lgcnhs_serve"]
          and serve_splits == 2 * launches["fused_lgcnhs_serve"],
          f"{merges['fused_lgcnhs_serve']} merges, {serve_splits} splits")
    for (model, args, k), n in zip(runs, run_launches):
        want = "fused_lgcnhs_serve" if model == "SpreadLightGCNOpti" else "fused_topk_retrieval"
        check(f"cli/retrieve {model} {args[1]} k={k} served through {want} alone",
              n == {name: int(name == want) for name in kernels}, f"{n}")

    timing_inputs = {}

    def output_checks(model, dataset, cfg, g, params, rec, timing_key):
        """The served (U, k) lists against the plain chain."""
        k = cfg.k
        label = f"cli/retrieve {model} {dataset} ({g.n_users}x{g.n_items}, k={k})"
        seen = cuda(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val))
        ue, ie = params.user_emb.to(dev), params.item_emb.to(dev)
        got = cuda(rec)
        check(f"{label} shape and id range", tuple(rec.shape) == (g.n_users, k)
              and bool(((got >= 0) & (got < g.n_items)).all()))
        enough = (~seen).sum(dim=1) >= k
        hits = seen.gather(1, got.long())[enough].any(dim=1)
        check(f"{label} no seen item for users with >= {k} unseen", not bool(hits.any()),
              f"{int(hits.sum())} users violate")
        if model == "LightGCNOpti":
            want = masked_topk(ue @ ie.T, seen, k)
            ref = retrieval_ref64(ue, ie, seen)
            timing_inputs[timing_key] = (ue, ie, seen, k)
        else:
            A = cuda(interaction_matrix(g.n_users, g.n_items, g.train, g.val))
            W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
            want = fs.fused_lgcnhs_serve_ref(ue, ie, A, W, seen, k)[0]
            ref = serve_ref64(ue, ie, A, W, seen)
            if timing_key:  # the 49,410-item catalog's W (9.8 GB) is not kept
                timing_inputs[timing_key] = (ue, ie, A, W, seen, k)
        agreement, gap = tie_equivalence(torch, want, got, ref)
        check(f"{label} tie-equivalent to the plain chain",
              agreement >= AGREEMENT_MIN and gap <= GAP_MAX,
              f"agreement {agreement:.6f}, max relative gap {gap:.3e}")
        del ref, want
        torch.cuda.empty_cache()

    timing_keys = {("LightGCNOpti", "movielens1m", K_SLICE): "fused_topk_retrieval",
                   ("LightGCNOpti", "synthetic", K_SLICE): "fused_topk_big",
                   ("LightGCNOpti", "synthetic", K_LARGE): "fused_topk_k1000",
                   ("SpreadLightGCNOpti", "movielens1m", K_SLICE): "fused_lgcnhs_serve"}
    for (model, args, k), rec in zip(runs, outputs):
        cfg, g, params = cells[(model, args[1], k)]
        output_checks(model, args[1], cfg, g, params, rec, timing_keys.get((model, args[1], k)))

    def float64_checks():
        """Float64 checkpoints at ML-1M through cli/retrieve: served at f64 on
        the card by the plain chain, as the JAX package serves them, with no
        kernel launched. The ids are held against the same chain at f64 on
        the card (identical) and against it on the CPU, another device's f64
        products: identical for LightGCNOpti; for SpreadLightGCNOpti, whose F
        is an f32 product summed in another order there, tie-equivalent
        under the CPU's scores."""
        work64 = tempfile.mkdtemp(prefix="chip_smoke_f64_", dir=os.path.join(ROOT, "artifacts"))
        for model in ("LightGCNOpti", "SpreadLightGCNOpti"):
            cfg, g, params = make_cell(model, ml1m, K_SLICE, work64, torch.float64)
            before = {name: fn.launches for name, fn in kernels.items()}
            rec = retrieve.main(["--device", "cuda", "--workdir", work64, "--model", model,
                                 *ml1m])
            counted = {name: fn.launches - before[name] for name, fn in kernels.items()}
            seen_h = torch.from_numpy(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val))
            ue_h, ie_h = params.user_emb.cpu(), params.item_emb.cpu()
            seen, ue, ie = cuda(seen_h), ue_h.to(dev), ie_h.to(dev)
            if model == "LightGCNOpti":
                want = masked_topk(ue @ ie.T, seen, K_SLICE)
                host = masked_topk(ue_h @ ie_h.T, seen_h, K_SLICE)
                ref = None
            else:
                A_h = torch.from_numpy(interaction_matrix(g.n_users, g.n_items, g.train, g.val))
                A = cuda(A_h)
                W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
                want = fs.fused_lgcnhs_serve_ref(ue, ie, A, W, seen, K_SLICE)[0]
                W_h = W.cpu()
                fused = (ue_h @ ie_h.T) * (A_h @ W_h)
                ref = torch.where(seen_h, torch.full_like(fused, fs.EXCLUDED), fused)
                host = select_topk(ref, K_SLICE)[1]
            got = cuda(rec)
            label = f"cli/retrieve {model} movielens1m float64 checkpoint"
            check(f"{label}: served at f64 on the card by the plain chain, no kernel "
                  "launched, identical to that chain run directly",
                  ue.dtype == torch.float64 and torch.equal(got, want)
                  and not any(counted.values()),
                  f"{int((got != want).sum())} mismatches, launches {counted}")
            if ref is None:
                check(f"{label}: identical to the chain at f64 on the CPU",
                      torch.equal(got.cpu(), host), f"{int((got.cpu() != host).sum())} mismatches")
            else:
                agreement, gap = tie_equivalence(torch, host, got.cpu(), ref)
                check(f"{label}: tie-equivalent to the chain on the CPU",
                      agreement >= AGREEMENT_MIN and gap <= GAP_MAX,
                      f"agreement {agreement:.6f}, max relative gap {gap:.3e}")
            del want, host, ref
        shutil.rmtree(work64, ignore_errors=True)

    check.guard("float64 checkpoints", float64_checks)
    torch.cuda.empty_cache()

    # -- 4, the main path: cli/main for all seven models --------------------
    print("[phase 4] cli/main end to end", flush=True)
    main_models = ("ProbS", "HeatS", "HybridS", "LightGCN", "LightGCNOpti",
                   "SpreadLightGCN", "SpreadLightGCNOpti")
    main_kernels = {**kernels, "dual_matmul": prop.dual_matmul}
    # LightGCN and SpreadLightGCN read a LightGCN-shaped checkpoint
    save_checkpoint(checkpoint_path(run_config("LightGCN", ml1m, work)),
                    init_lightgcn(torch.Generator().manual_seed(SEED), graph.n_users,
                                  graph.n_items, 64))

    clock = StepClock()
    logging.getLogger("lgcnhs").addHandler(clock)
    main_rows, main_metrics = [], {}
    main_launches = dict.fromkeys(main_kernels, 0)  # over every cli/main run

    def main_ref64(model, cfg, g):
        """(U, I) f64 scores a list is read against, computed on the card:
        the masked layer-0 scores, the spread F or the fused G * F (seen
        entries as computed: the seen filter is checked apart), F by the
        algorithm the f32 run picks."""
        seen = cuda(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val))
        if model in SPREAD_METHODS:
            lam, transpose_w, _ = resolve_spread_variant(model, cfg.dataset,
                                                         cfg.hparams.lambda_)
        else:
            params = load_checkpoint(checkpoint_path(cfg), dev)
            ue, ie = params.user_emb.double(), params.item_emb.double()
            if model in ("LightGCN", "LightGCNOpti"):
                return retrieval_ref64(ue, ie, seen)
            lam, transpose_w = cfg.hparams.lambda_, False
        A = cuda(interaction_matrix(g.n_users, g.n_items, g.train, g.val, dtype=np.float64))
        algo = {"dense": tdiff.diffusion_scores,
                "factored": tdiff.user_factored_diffusion_scores}[
            tdiff.choose_diffusion(g.n_users, g.n_items)]
        F = algo(A, torch.tensor(lam, dtype=torch.float32).double(), transpose_w=transpose_w)
        del A
        if model in SPREAD_METHODS:
            return F
        return F.mul_(torch.where(seen, torch.full_like(F, MASK_VALUE), ue @ ie.T))

    def main_run(model, args, workdir, label):
        """cli/main on the card, every launch count set to 0 just before it
        and read just after; its list and metrics held against the CPU."""
        for fn in main_kernels.values():
            fn.launches = 0
        clock.marks.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        metrics = cli_main.main(["--device", "cuda", "--workdir", workdir, "--model", model,
                                 *args])
        host_s = time.perf_counter() - t0
        counted = {name: fn.launches for name, fn in main_kernels.items()}
        for name, n in counted.items():
            main_launches[name] += n
        marks = clock.marks
        main_rows.append({"run": label, "host_s": host_s,
                          "step2_s": marks["step3"] - marks["step2"],
                          "step3_s": marks["end"] - marks["step3"],
                          "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9})
        main_metrics[label] = metrics
        print(f"[phase 4] cli/main {label}: {json.dumps(metrics)} in {host_s:.2f} s, "
              f"launches {counted}", flush=True)
        want = {name: int(name == "fused_topk_retrieval"
                          and model in ("LightGCN", "LightGCNOpti")) for name in main_kernels}
        check(f"cli/main {label}: launches {want} (no serving kernel, no training)",
              counted == want, f"{counted}")

        cfg = run_config(model, args, workdir)
        g = graph if args is ml1m else cells[("LightGCNOpti", "synthetic", K_SLICE)][1]
        rec = np.load(os.path.join(cfg.recommend_path, f"all_user_recommend_{model}_{cfg.k}.npy"))
        got = cuda(rec).long()
        k = cfg.k
        check(f"cli/main {label}: shape, id range, distinct ids",
              tuple(rec.shape) == (g.n_users, k) and bool(((got >= 0) & (got < g.n_items)).all())
              and bool((got.sort(dim=1)[0].diff(dim=1) > 0).all()))
        seen = cuda(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val))
        if model not in SPREAD_METHODS or resolve_spread_variant(
                model, cfg.dataset, cfg.hparams.lambda_)[2]:
            enough = (~seen).sum(dim=1) >= k
            hits = seen.gather(1, got)[enough].any(dim=1)
            check(f"cli/main {label}: no seen item for users with >= {k} unseen",
                  not bool(hits.any()), f"{int(hits.sum())} users violate")
        del seen
        # the same recommendation on the CPU, and the f64 scores on the card
        t0 = time.perf_counter()
        want_rec = recommend(g, cfg, "cpu")
        cpu_s = time.perf_counter() - t0
        ref = main_ref64(model, cfg, g)
        agreement, gap = tie_equivalence(torch, cuda(want_rec), got, ref)
        check(f"cli/main {label}: the list identical to the CPU run's, or tie-equivalent "
              "under f64", agreement == 1.0 or (agreement >= AGREEMENT_MIN and gap <= GAP_MAX),
              f"agreement {agreement:.6f}, mismatched-slot max relative gap {gap:.3e}; "
              f"CPU run {cpu_s:.2f} s")
        del ref
        torch.cuda.empty_cache()
        # the metrics: the card's against the card's list evaluated on the
        # CPU (past 10,000 items without the (I, I) similarity matrix: 29.5
        # TFLOP on the CPU at 49,410 items)
        ctx_card = tev.EvalContext.build(g.n_users, g.n_items, g.test, g.train, g.val, dev)
        ctx_cpu = tev.EvalContext.build(g.n_users, g.n_items, g.test, g.train, g.val, "cpu")
        card_un = unrounded(ctx_card, rec, False)
        cpu_un = unrounded(ctx_cpu, rec, g.n_items > 10_000)
        torch.cuda.empty_cache()
        bad = metrics_disagree(metrics, card_un, cpu_un)
        check(f"cli/main {label}: metrics equal the CPU's (or differ only across a "
              "5-decimal boundary within 1e-5)", not bad,
              f"disagree on {bad}; card {card_un}, CPU {cpu_un}")

    for model in main_models:
        check.guard(f"cli/main {model}", main_run, model, ml1m, work, f"{model} movielens1m")
    for model in ("LightGCNOpti", "SpreadLightGCNOpti"):
        check.guard(f"cli/main {model} 49,410 items", main_run, model, big, work,
                    f"{model} {BIG_CATALOG}-item draw")

    # the training slice: an empty workdir, so cli/retrieve trains first
    print(f"[phase 4] cli/retrieve trains LightGCNOpti ({TRAIN_EPOCHS} epochs) and serves",
          flush=True)
    train_work = tempfile.mkdtemp(prefix="chip_smoke_train_", dir=os.path.join(ROOT, "artifacts"))
    path_kernels = {**kernels, "dual_matmul": prop.dual_matmul}
    for fn in path_kernels.values():
        fn.launches = 0
    prop.dual_matmul.reduce_launches = 0
    t0 = time.perf_counter()
    rec = retrieve.main(["--device", "cuda", "--workdir", train_work, "--model",
                         "SpreadLightGCNOpti", *ml1m, "--epochs", str(TRAIN_EPOCHS)])
    torch.cuda.synchronize()
    train_serve_s = time.perf_counter() - t0
    train_launches = {name: fn.launches for name, fn in path_kernels.items()}
    reduce_launches = prop.dual_matmul.reduce_launches
    print(f"[phase 4] train + serve in {train_serve_s:.2f} s; launches {train_launches}, "
          f"dual_matmul split-K sum {reduce_launches}", flush=True)
    check(f"training path launched dual_matmul 6 x {TRAIN_EPOCHS}",
          train_launches["dual_matmul"] == 6 * TRAIN_EPOCHS, f"{train_launches['dual_matmul']}")
    check("training path launched dual_matmul's split-K sum with each call",
          reduce_launches == train_launches["dual_matmul"], f"{reduce_launches}")
    check("training path launched fused_lgcnhs_serve", train_launches["fused_lgcnhs_serve"] > 0)
    cfg_t = tcfg.load_config(env="prod", dataset="movielens1m", model="SpreadLightGCNOpti",
                             workdir=train_work, overrides={"hparams.epochs": TRAIN_EPOCHS})
    with open(os.path.join(cfg_t.pictures_path, f"LightGCNOpti_{cfg_t.k}_val_metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    history = {name: [float(r[name]) for r in rows] for name in rows[0]}
    print(f"[phase 4] history {json.dumps(history)}", flush=True)
    check("training history: every value finite",
          all(math.isfinite(v) for col in history.values() for v in col))
    iters = [int(v) for v in history["iters"]]
    check(f"training history: evals at {list(range(0, TRAIN_EPOCHS, 200))}",
          iters == list(range(0, TRAIN_EPOCHS, 200)), f"{iters}")
    tl = dict(zip(iters, history["train_loss"]))
    check("training: train loss at epoch 800 below epoch 0", tl.get(800, 0.0) < tl.get(0, 0.0),
          f"{tl.get(0)} -> {tl.get(800)}")
    params_t = load_checkpoint(checkpoint_path(cfg_t), dev)
    output_checks("SpreadLightGCNOpti", "movielens1m (trained)", cfg_t, graph, params_t, rec,
                  "fused_lgcnhs_serve")

    # cli/main on the trained checkpoint: it must load it, not train again
    for model in ("LightGCNOpti", "SpreadLightGCNOpti"):
        label = f"{model} movielens1m trained"
        check.guard(f"cli/main {label}", main_run, model, ml1m, train_work, label)
        trained = main_metrics.get(label, {}).get("R", 0.0)
        random = main_metrics.get(f"{model} movielens1m", {}).get("R", 1.0)
        check(f"cli/main {model}: R@{K_SLICE} of the trained tables above the random tables'",
              trained > random, f"{trained} against {random}")

    def twin_route_compare():
        """TWIN_EPOCHS epochs from one seed on the kernel route and on the
        same route with the plain twin in the kernel's place."""
        cfg20 = tcfg.load_config(env="prod", dataset="movielens1m", model="LightGCNOpti",
                                 workdir=train_work,
                                 overrides={"hparams.epochs": TWIN_EPOCHS,
                                            "hparams.epoch_per_eval": 10})
        results, counts = {}, {}
        for route in ("kernel", "twin"):
            kernel_fn = prop.dual_matmul
            if route == "twin":
                prop.dual_matmul = prop.dual_matmul_ref
            kernel_fn.launches = 0
            try:
                results[route] = trainer.train_lightgcn(graph, cfg20, feats_u, feats_i,
                                                        save_artifacts=False, device=dev)
            finally:
                prop.dual_matmul = kernel_fn
            counts[route] = kernel_fn.launches
        check("twin route: kernel launched 6 a step, twin route none",
              counts == {"kernel": 6 * TWIN_EPOCHS, "twin": 0}, f"{counts}")
        hk, ht = results["kernel"].history, results["twin"].history
        loss_gap = max(abs(a - b) for col in ("train_loss", "val_loss")
                       for a, b in zip(hk[col], ht[col]))
        table_gap = max((a - b).abs().max().item() for a, b in
                        zip(results["kernel"].params, results["twin"].params))
        scale = max(t.abs().max().item() for t in results["twin"].params)
        print(f"[phase 4] kernel vs twin route, {TWIN_EPOCHS} epochs: losses "
              f"{hk['train_loss']} / {ht['train_loss']}, max loss gap {loss_gap:.3e}, "
              f"max table gap {table_gap:.3e} (table scale {scale:.3e})", flush=True)
        check(f"kernel route tracks the twin route over {TWIN_EPOCHS} epochs: losses",
              loss_gap <= TWIN_LOSS_TOL, f"max gap {loss_gap:.3e}, tolerance {TWIN_LOSS_TOL:g}")
        check(f"kernel route tracks the twin route over {TWIN_EPOCHS} epochs: tables",
              table_gap <= TWIN_TABLE_TOL,
              f"max gap {table_gap:.3e}, tolerance {TWIN_TABLE_TOL:g}")

    check.guard("kernel route against the twin route", twin_route_compare)

    # -- 7. the single-device entry points, on phase 4's workdirs ------------
    print(f"[phase 7] find_lambda, resume, evaluate, ablation on {smi}", flush=True)
    torch.cuda.empty_cache()
    phase7 = check.guard("phase 7", lambda_resume_report_phase, check, dev, smi, {
        "kernels": main_kernels, "config": run_config, "ml1m": ml1m, "graph": graph,
        "feats": (feats_u, feats_i), "big": big,
        "big_graph": cells[("LightGCNOpti", "synthetic", K_SLICE)][1], "work": work,
        "train_work": train_work, "main_metrics": main_metrics, "models": main_models})
    if phase7:
        print(f"[phase 7] rows {json.dumps(phase7['runs'])}", flush=True)
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)

    # -- 5. timings at the main path's shapes ------------------------------
    print(f"[phase 5] timings on {smi}", flush=True)
    report = []
    sources = {
        "fused_topk_retrieval": ("lgcnhs_tpu_torch/ops/cuda/retrieval.cu",
                                 "lgcnhs_tpu/ops/pallas/retrieval.py:110"),
        "fused_lgcnhs_serve": ("lgcnhs_tpu_torch/ops/cuda/fusion_serve.cu",
                               "lgcnhs_tpu/ops/pallas/fusion_serve.py:120"),
    }

    def device_ms_by_kernel(fn, n):
        """{kernel name: device ms per call of fn} from torch.profiler over
        n calls, and the window's wall ms; ({}, None) when it traces no
        device time."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / n
        except Exception:  # no device trace: reported as not measured
            traceback.print_exc()
            return {}, None
        by_kernel = {}
        for ev in prof.key_averages():
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
                by_kernel[ev.key] = dev_us / 1e3 / n
        return by_kernel, wall_ms

    for name, fn in kernels.items():
        inputs = timing_inputs[name]
        twin = fs.fused_lgcnhs_serve_ref if name == "fused_lgcnhs_serve" \
            else rt.fused_topk_retrieval_ref
        got, want = fn(*inputs), twin(*inputs)
        max_abs_err = (got[1] - want[1]).abs().max().item()
        reps = 10
        ms = median_ms(torch, lambda: fn(*inputs), reps)
        plain_ms = median_ms(torch, lambda: twin(*inputs), reps)
        if name == "fused_lgcnhs_serve":
            ue, ie, A, W, seen, k = inputs
            U, D = ue.shape
            I = ie.shape[0]

            def composition():
                fused = torch.matmul(ue, ie.T) * torch.matmul(A, W)
                return torch.topk(fused.masked_fill_(seen, fs.EXCLUDED), k, dim=1)

            nnz = int((A != 0).sum())
            nbytes = 4 * (U * D + I * D + U * I + I * I) + U * I + 8 * U * k
            flops = 2 * nnz * I + 2 * U * I * D + U * I
            # the design's own floor: its dense F (three bf16 parts of W)
            dense_floor_ms = 3 * 2 * U * I * I / PEAK_BF16_FLOP_PER_S * 1e3
        else:
            ue, ie, seen, k = inputs
            U, D = ue.shape
            I = ie.shape[0]

            def composition():
                return torch.topk(torch.matmul(ue, ie.T).masked_fill_(seen, MASK_VALUE), k, dim=1)

            nbytes = 4 * (U * D + I * D) + U * I + 8 * U * k
            flops = 2 * U * I * D
        # no single PyTorch call computes either function (library_ms is
        # null); the nearest library composition is timed beside it
        composition_ms = median_ms(torch, composition, reps)
        bound_ms, bound_by = bound(nbytes, flops)
        src, replaces = sources[name]
        row = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
               "launches": launches[name], "max_abs_err": max_abs_err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "matmul_topk_ms": composition_ms}
        own = {"fused_topk_retrieval": ("fused_topk_kernel", "part_lists_merge"),
               "fused_lgcnhs_serve": ("fused_serve_kernel", "part_lists_merge", "bf16_parts")}

        def own_device_ms(call):
            """(device ms of one call's own kernels, {kernel: ms})."""
            by_kernel, _ = device_ms_by_kernel(call, 5)
            return (sum(v for n_, v in by_kernel.items() if any(o in n_ for o in own[name]))
                    or None), by_kernel

        dev_ms, by_kernel = own_device_ms(lambda: fn(*inputs))
        comp_kernels, _ = device_ms_by_kernel(composition, 5)
        comp_dev = sum(comp_kernels.values()) or None
        row.update(device_ms=dev_ms, matmul_topk_device_ms=comp_dev,
                   bound_share=bound_ms / dev_ms if dev_ms else None,
                   merge_launches=merges[name])
        extra = (f", device {dev_ms} ms ({row['bound_share']} of the bound; matmul+topk "
                 f"device {comp_dev}), kernels {by_kernel}; {merges[name]} merge launches")
        if name == "fused_lgcnhs_serve":
            row.update(split_launches=serve_splits)
            extra += f", {serve_splits} split launches; dense floor {dense_floor_ms} ms"
        else:
            # the same kernel takes the place of the streaming Pallas kernel:
            # timed over the 49,410-item catalog at k=100 and at k=1000 too
            row["also_replaces"] = "lgcnhs_tpu/ops/pallas/retrieval.py:265"
            for key in ("fused_topk_big", "fused_topk_k1000"):
                big_in = timing_inputs[key]
                bu, bi, bseen, bk = big_in
                tag = f"catalog_{bi.shape[0]}_k{bk}"
                big_ms = median_ms(torch, lambda: fn(*big_in), reps)
                big_dev = own_device_ms(lambda: fn(*big_in))[0]

                def big_composition():
                    return torch.topk(torch.matmul(bu, bi.T).masked_fill_(bseen, MASK_VALUE),
                                      bk, dim=1)

                # matmul+topk on the same inputs, in the same call as the kernel
                comp_ms = median_ms(torch, big_composition, reps)
                comp_dev = sum(device_ms_by_kernel(big_composition, 5)[0].values()) or None
                row.update({f"{tag}_ms": big_ms, f"{tag}_device_ms": big_dev,
                            f"{tag}_matmul_topk_ms": comp_ms,
                            f"{tag}_matmul_topk_device_ms": comp_dev})
                extra += (f"; {tag} {big_ms:.4f} ms (device {big_dev}), matmul+topk "
                          f"{comp_ms:.4f} (device {comp_dev})")
        print(f"[phase 5] {name} U={U} I={I} D={D} k={k}: {ms:.4f} ms (twin {plain_ms:.4f}, "
              f"matmul+topk {composition_ms:.4f}, bound {bound_ms:.4f} by {bound_by}) "
              f"max_abs_err {max_abs_err:.3e}{extra} [{smi}]", flush=True)
        report.append(row)

    def serve_catalog_timing():
        """Fused serving over the 49,410-item catalog beside matmul+topk on
        the same inputs (the library composition), as at ML-1M above."""
        cfg, g, params = cells[("SpreadLightGCNOpti", "synthetic", K_SLICE)]
        ue, ie = params.user_emb.to(dev), params.item_emb.to(dev)
        A = cuda(interaction_matrix(g.n_users, g.n_items, g.train, g.val))
        seen = A > 0
        W = hybrid_transfer(A, general_spreading_matrix(A), cfg.hparams.lambda_)
        torch.cuda.empty_cache()
        U, D = ue.shape
        I, k = ie.shape[0], K_SLICE

        def serve():
            return fs.fused_lgcnhs_serve(ue, ie, A, W, seen, k)

        def composition():
            fused = torch.matmul(ue, ie.T) * torch.matmul(A, W)
            return torch.topk(fused.masked_fill_(seen, fs.EXCLUDED), k, dim=1)

        ms, comp_ms = median_ms(torch, serve, 3), median_ms(torch, composition, 3)
        serve_dev = sum(device_ms_by_kernel(serve, 2)[0].values()) or None
        comp_dev = sum(device_ms_by_kernel(composition, 2)[0].values()) or None
        nnz = int((A != 0).sum())
        big_bound = bound(4 * (U * D + I * D + U * I + I * I) + U * I + 8 * U * k,
                          2 * nnz * I + 2 * U * I * D + U * I)
        tag = f"catalog_{I}"
        next(r for r in report if r["name"] == "fused_lgcnhs_serve").update({
            f"{tag}_ms": ms, f"{tag}_device_ms": serve_dev, f"{tag}_matmul_topk_ms": comp_ms,
            f"{tag}_matmul_topk_device_ms": comp_dev, f"{tag}_bound_ms": big_bound[0]})
        print(f"[phase 5] fused_lgcnhs_serve U={U} I={I} D={D} k={k}: {ms:.4f} ms (device "
              f"{serve_dev}), matmul+topk {comp_ms:.4f} ms (device {comp_dev}), bound "
              f"{big_bound[0]:.4f} by {big_bound[1]} [{smi}]", flush=True)
        del W, A, seen
        torch.cuda.empty_cache()

    check.guard("fused serving timed over 49,410 items", serve_catalog_timing)

    # dual_matmul at the training step's shapes: the slice's int8 incidence
    # (padded once per run, as the trainer does) and the bf16 layer-0
    # operands of the trained tables
    U, I, D = graph.n_users, graph.n_items, 64
    X = (di_slice[:, None] * params_t.item_emb).to(torch.bfloat16)
    Y = (du_slice[:, None] * params_t.user_emb).to(torch.bfloat16)
    R8p = prop.pad_for_dual(R8_slice)
    got = prop.dual_matmul(R8p, X, Y)
    want = prop.dual_matmul_ref(R8_slice, X, Y)
    max_abs_err = max((a - b).abs().max().item() for a, b in zip(got, want))
    reps = 20
    ms = median_ms(torch, lambda: prop.dual_matmul(R8p, X, Y), reps)
    pad_ms = median_ms(torch, lambda: prop.pad_for_dual(R8_slice), reps)
    Xg, Yg = X.detach().requires_grad_(True), Y.detach().requires_grad_(True)
    out = prop.dual_matmul(R8p, Xg, Yg)
    cot = (torch.randn_like(out[0]), torch.randn_like(out[1]))
    bwd_ms = median_ms(torch, lambda: torch.autograd.grad(out, (Xg, Yg), cot, retain_graph=True),
                       reps)
    plain_ms = median_ms(torch, lambda: prop.dual_matmul_ref(R8_slice, X, Y), reps)
    Rb = R8_slice.to(torch.bfloat16)
    matmul_ms = median_ms(torch, lambda: (torch.matmul(Rb, X), torch.matmul(Rb.T, Y)), reps)
    matmul_dev, _ = device_ms_by_kernel(lambda: (torch.matmul(Rb, X), torch.matmul(Rb.T, Y)),
                                        20)
    del Rb
    dual_dev, _ = device_ms_by_kernel(lambda: prop.dual_matmul(R8p, X, Y), 20)
    dual_device_ms = sum(dual_dev.values()) if dual_dev else None
    matmul_device_ms = sum(matmul_dev.values()) if matmul_dev else None
    nnz = int(R8_slice.sum(dtype=torch.int64))
    deg_u = R8_slice.sum(dim=1, dtype=torch.int64)
    deg_i = R8_slice.sum(dim=0, dtype=torch.int64)
    skew = (f"degrees: users max {int(deg_u.max())}, items max {int(deg_i.max())}, "
            f"items p99 {float(deg_i.double().quantile(0.99)):.1f}")
    # each input read once (R int8, X and Y bf16), each output written once (f32)
    nbytes = U * I + 2 * (I * D + U * D) + 4 * (U * D + I * D)
    bound_ms, bound_by = bound(nbytes, 4 * nnz * D, PEAK_BF16_FLOP_PER_S)
    share = f"{bound_ms / dual_device_ms:.3f}" if dual_device_ms else "not measured"
    report.append({
        "name": "dual_matmul", "route": "cuda",
        "source": "lgcnhs_tpu_torch/ops/cuda/propagation.cu",
        "replaces": "lgcnhs_tpu/ops/pallas/propagation.py:164",
        "launches": train_launches["dual_matmul"], "reduce_launches": reduce_launches,
        "max_abs_err": max_abs_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "matmul_ms": matmul_ms, "matmul_device_ms": matmul_device_ms,
        "backward_ms": bwd_ms, "device_ms": dual_device_ms, "pad_ms": pad_ms,
        "bound_share": bound_ms / dual_device_ms if dual_device_ms else None,
    })
    dual_row = report[-1]
    if phase7:
        dual_row.update({f"resume_launches_{run}": n
                         for run, n in phase7["resume_launches"].items()})
    print(f"[phase 5] dual_matmul U={U} I={I} D={D} nnz={nnz} int8/bf16: forward {ms:.4f} ms "
          f"(device {dual_device_ms}, {share} of the bound), backward {bwd_ms:.4f} ms, "
          f"row padding {pad_ms:.4f} ms once per run, twin {plain_ms:.4f}, two bf16 matmuls "
          f"{matmul_ms:.4f} (device {matmul_device_ms}), bound {bound_ms:.4f} by {bound_by}, "
          f"max_abs_err {max_abs_err:.3e}; {skew}; device ms by kernel {dual_dev} [{smi}]",
          flush=True)

    # the train step over a synchronized steady window, then its device
    # time by kernel
    hp = cfg_t.hparams
    p0 = init_lightgcn_opti(torch.Generator().manual_seed(SEED), feats_u, feats_i, D, dev)
    p0 = LightGCNParams(*(t.clone().requires_grad_(True) for t in p0))
    step = trainer.make_train_step(trainer.make_optimizer(hp, p0), hp, I,
                                   bf16_matmul=True, use_kernel=True)
    te = unique_edges(graph.train)
    step_args = ((R8p, du_slice, di_slice),
                 torch.from_numpy(te.users.astype(np.int64)).to(dev),
                 torch.from_numpy(te.items.astype(np.int64)).to(dev),
                 cuda(pos_bool_matrix(U, I, graph.train)))
    epoch = [0]

    def one_step():
        e = epoch[0]
        epoch[0] += 1
        return step(p0, e, trainer.epoch_generator(hp.seed, e, dev), *step_args)

    for _ in range(20):
        one_step()
    torch.cuda.synchronize()
    n_steps = 200
    t0 = time.perf_counter()
    for _ in range(n_steps):
        one_step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    step_dev, step_wall = device_ms_by_kernel(one_step, 20)
    busy_ms = sum(step_dev.values())
    dual_step_ms = sum(v for k, v in step_dev.items() if "dual_" in k)
    top = sorted(step_dev.items(), key=lambda kv: -kv[1])[:8]
    idle = f"{1 - busy_ms / step_wall:.3f}" if step_dev and step_wall else "not measured"
    dual_row.update(step_ms=step_ms, step_device_busy_ms=busy_ms, step_idle_share=idle,
                    step_dual_device_ms=dual_step_ms)
    print(f"[phase 5] train step (int8 dual_matmul route, B={hp.batch_size}): {step_ms:.4f} ms, "
          f"{hp.batch_size / step_ms * 1e3:.1f} examples/s over {n_steps} steps; profiled "
          f"window {step_wall} ms/step, device busy {busy_ms:.4f} ms/step "
          f"(idle share {idle}), dual_matmul kernels {dual_step_ms:.4f} ms/step; top kernels "
          f"{json.dumps([(k[:60], round(v, 5)) for k, v in top])} [{smi}]", flush=True)

    for row in report:
        row["cli_main_launches"] = main_launches[row["name"]]
        if phase7:  # find_lambda, evaluate and ablation launch none
            row["phase7_launches"] = sum(r["launches"][row["name"]] for r in phase7["runs"])
    # cli/main: host seconds per run and step (phase 4's runs), then where
    # the device stages of SpreadLightGCNOpti go
    for row in main_rows:
        print(f"[phase 5] cli/main {row['run']}: {row['host_s']:.4f} s host (Step 2 recommend "
              f"{row['step2_s']:.4f} s, Step 3 evaluate {row['step3_s']:.4f} s), peak device "
              f"memory {row['peak_device_gb']:.2f} GB [{smi}]", flush=True)
    print(f"[phase 5] cli/main rows {json.dumps(main_rows)}", flush=True)

    def host_ms(fn, reps=3):
        """Median host ms of fn() with the card synchronized around it."""
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            del out
        return sorted(times)[reps // 2]

    def main_breakdown(key):
        """Host ms of each device stage of cli/main's SpreadLightGCNOpti
        recommendation and evaluation, with the data already on the card."""
        cfg, g, params = cells[key]
        P = LightGCNParams(params.user_emb.to(dev), params.item_emb.to(dev))
        A = cuda(interaction_matrix(g.n_users, g.n_items, g.train, g.val))
        seen = cuda(pos_bool_matrix(g.n_users, g.n_items, g.train, g.val))
        lam = torch.tensor(cfg.hparams.lambda_, dtype=torch.float32)
        F_new = allocate_matrix(P, seen) * tdiff.diffusion_scores_auto(A, lam)
        rec = rank_exclude_seen_topk(F_new, seen, K_SLICE)
        ctx = tev.EvalContext.build(g.n_users, g.n_items, g.test, g.train, g.val, dev)
        rec_t, inter, deg = ctx.on_device(rec), ctx.on_device(ctx.interaction), \
            ctx.on_device(ctx.item_deg)
        stages = {
            f"diffusion ({tdiff.choose_diffusion(g.n_users, g.n_items)})":
                lambda: tdiff.diffusion_scores_auto(A, lam),
            "G": lambda: allocate_matrix(P, seen),
            "G * F": lambda: F_new * F_new,  # one (U, I) product, G * F's cost
            "ranking (rank_exclude_seen_topk, two width-I sorts)":
                lambda: rank_exclude_seen_topk(F_new, seen, K_SLICE),
            "evaluate (six metrics, host arrays moved in)":
                lambda: tev.evaluate_recommendations(ctx, rec),
            "of which I@k (similarity matrix and bilinear form)":
                lambda: metrics_ops.internal_similarity(rec_t, inter, deg),
        }
        ms = {name: host_ms(fn) for name, fn in stages.items()}
        print(f"[phase 5] cli/main SpreadLightGCNOpti {g.n_users}x{g.n_items} stages, host ms "
              f"on the card: {json.dumps(ms)} [{smi}]", flush=True)
        del A, seen, F_new, rec_t, inter
        torch.cuda.empty_cache()

    for key in (("SpreadLightGCNOpti", "movielens1m", K_SLICE),
                ("SpreadLightGCNOpti", "synthetic", K_SLICE)):
        check.guard(f"cli/main stages {key[1]}", main_breakdown, key)

    # -- 6. large graphs on one card -------------------------------------
    print(f"[phase 6] large graphs: {LARGE_USERS} x {LARGE_ITEMS} on {smi}", flush=True)
    large = check.guard("large graphs", large_graph_phase, check, dev, smi, clock)
    if large:
        c, d = large["chunk"], large["dual"]
        report.append({
            "name": CHUNKED, "route": "cuda",
            "source": "lgcnhs_tpu_torch/ops/cuda/retrieval.cu",
            "replaces": "lgcnhs_tpu/ops/pallas/retrieval.py:110",
            "call_site": "lgcnhs_tpu/ops/scalable.py:151",
            "launches": large["chunk_launches"], "max_abs_err": c["max_abs_err"], "ms": c["ms"],
            "plain_ms": c["plain_ms"], "bound_ms": c["bound"][0], "bound_by": c["bound"][1],
            "library_ms": None, "shape": c["shape"],
        })
        dual_row.update(large_graph_launches=large["dual_launches"], large_graph_ms=d["ms"],
                        large_graph_plain_ms=d["plain_ms"], large_graph_bound_ms=d["bound"][0],
                        large_graph_bound_by=d["bound"][1],
                        large_graph_max_rel_err=d["max_rel_err"], large_graph_shape=d["shape"])
        print(f"[phase 6] rows {json.dumps(large['runs'] + [large['main_row']])}", flush=True)
        print(f"[phase 6] COO vs dense at ML-1M {json.dumps(large['coo_vs_dense'])}", flush=True)

    accum = check.guard("dual_matmul accumulation", dual_accumulation_check, check, dev, smi)
    if accum:
        dual_row["accumulation_by_length"] = accum

    # -- 8. raw-data ingestion through --data-dir --------------------------
    print(f"[phase 8] ingestion: ML-100K, ML-1M and Douban files on {smi}", flush=True)
    t0 = time.perf_counter()
    phase8 = check.guard("ingestion", ingestion_phase, check, dev, smi, clock)
    if phase8:
        print(f"[phase 8] {time.perf_counter() - t0:.1f} s; launches {phase8['launches']}; "
              f"word2vec gaps {json.dumps(phase8['w2v_gaps'])}", flush=True)
        print(f"[phase 8] rows {json.dumps(phase8['ingest'] + phase8['runs'])}", flush=True)
        for row in report:
            row["phase8_launches"] = phase8["launches"][row["name"]]
        for name, n in phase8["launches"].items():
            if name != CHUNKED:
                check(f"phase 8 launched {name} on ingested data", n > 0, f"{n} launches")

    # -- 9. the mesh on NCCL at world size 1 -------------------------------
    print(f"[phase 9] the mesh at world size 1 on {smi}", flush=True)
    t0 = time.perf_counter()
    big_cfg, big_g, big_params = cells[("LightGCNOpti", "synthetic", K_SLICE)]
    ml1m_params = cells[("LightGCNOpti", "movielens1m", K_SLICE)][2]
    phase9 = check.guard("mesh", mesh_phase, check, dev, smi, {
        "kernels": main_kernels, "graph": graph, "feats": (feats_u, feats_i),
        "fused_params": cells[("SpreadLightGCNOpti", "movielens1m", K_SLICE)][2],
        "retrieval": [(graph, ml1m_params, K_SLICE, "movielens1m"),
                      (big_g, big_params, K_SLICE, f"synthetic {big_g.n_items} items"),
                      (big_g, big_params, K_LARGE, f"synthetic {big_g.n_items} items")]})
    if phase9:
        print(f"[phase 9] {time.perf_counter() - t0:.1f} s; launches {phase9['launches']}",
              flush=True)
        print(f"[phase 9] rows {json.dumps(phase9['rows'])}", flush=True)
        for row in report:
            row["phase9_launches"] = phase9["launches"][row["name"]]
        for name in ("dual_matmul", "fused_topk_retrieval"):
            check(f"phase 9 launched {name} on the mesh path", phase9["launches"][name] > 0,
                  f"{phase9['launches'][name]} launches")

    # -- 10. the mesh's large-graph half at world size 1 ---------------------
    print(f"[phase 10] the mesh on the large graph at world size 1 on {smi}", flush=True)
    t0 = time.perf_counter()
    phase10 = check.guard("mesh large graph", mesh_large_phase, check, dev, smi,
                          {"kernels": main_kernels})
    if phase10:
        print(f"[phase 10] {time.perf_counter() - t0:.1f} s; launches {phase10['launches']}",
              flush=True)
        print(f"[phase 10] rows {json.dumps(phase10['rows'])}", flush=True)
        site = phase10["site"]
        report.append({
            "name": DISTRIBUTED, "route": "cuda",
            "source": "lgcnhs_tpu_torch/ops/cuda/retrieval.cu",
            "replaces": "lgcnhs_tpu/ops/pallas/retrieval.py:110",
            "call_site": "lgcnhs_tpu/parallel/sharding.py:938",
            "launches": phase10["launches"][DISTRIBUTED], "max_abs_err": site["max_abs_err"],
            "ms": site["ms"], "plain_ms": site["plain_ms"], "bound_ms": site["bound"][0],
            "bound_by": site["bound"][1], "library_ms": None,
            "matmul_topk_ms": site["matmul_topk_ms"], "shape": site["shape"],
        })
        for row in report:
            row["phase10_launches"] = phase10["launches"][row["name"]]
        check(f"phase 10 launched fused_topk_retrieval at {DISTRIBUTED}",
              phase10["launches"][DISTRIBUTED] > 0,
              f"{phase10['launches'][DISTRIBUTED]} launches")
        check(f"phase 10: the retrieval kernel at the distributed CSR site: ids identical to "
              "its plain twin on the first chunk", site["ids_identical"],
              f"max_abs_err {site['max_abs_err']:.3e}")

    # -- 11. the experimental models, --profile and cli/parity_report --------
    print(f"[phase 11] autoencoders, --profile and parity_report on {smi}", flush=True)
    t0 = time.perf_counter()
    phase11 = check.guard("phase 11", experimental_phase, check, dev, smi,
                          {"kernels": main_kernels, "train_work": train_work, "ml1m": ml1m})
    shutil.rmtree(train_work, ignore_errors=True)
    if phase11:
        print(f"[phase 11] {time.perf_counter() - t0:.1f} s (budget 30 s); launches "
              f"{phase11['launches']} [{smi}]", flush=True)
        print(f"[phase 11] rows {json.dumps(phase11['rows'])}", flush=True)
        for row in report:
            row["phase11_launches"] = phase11["launches"][row["name"]]

    # -- 12. bench_torch.py in a fresh process ----------------------------------
    print(f"[phase 12] bench_torch.py on {smi}", flush=True)
    phase12 = check.guard("phase 12", bench_phase, check, smi)
    if phase12:
        print(f"[phase 12] {phase12['s']:.1f} s (budget {BENCH_BUDGET_S} s); launches "
              f"{phase12['launches']} [{smi}]", flush=True)
        for row in report:  # the call sites inside ops/scalable and the mesh: none
            row["phase12_launches"] = phase12["launches"].get(row["name"], 0)

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    if check.failures:
        print(f"chip_smoke: {len(check.failures)} FAILED: {check.failures}", flush=True)
        return 1
    print(json.dumps({"kernels": report}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

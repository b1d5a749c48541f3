"""LightGCN / LightGCNOpti training, and the trainer's checkpoint IO.

Port of the single-device branches of ``lgcnhs_tpu/train/trainer.py``
(reference ``model/LightGCN/train.py:62-223``), with its semantics:

- one "epoch" = ONE minibatch step of ``batch_size`` BPR triples sampled
  with replacement from the (deduped) train edges; the full-graph forward
  runs every step;
- Adam(lr) with the lr decayed by ``gamma`` every ``epoch_per_lr_decay``
  epochs, skipping epoch 0: lr(e) = lr0 * gamma^max(0, floor((e-1)/decay));
- every ``epoch_per_eval`` epochs: the val loss forwarded on the VAL
  adjacency over every val edge once, the six-metric-column history from
  layer-0 recommendations with train positives masked;
- the history saved as CSV (and PNG curves where matplotlib imports), the
  final tables as an npz checkpoint the JAX trainer's loader reads too;
- with ``checkpoint_dir``, the full state (tables, Adam's moments and step)
  saved every ``checkpoint_every`` epochs (``train/checkpoint.py``), and a
  run resumes after the newest checkpoint's epoch with the previous run's
  history rows before it carried over.

JAX runs the epochs between two eval or checkpoint boundaries as one
jitted ``lax.scan`` (``make_train_scan``, ``make_coo_train_scan``), at most
``compute.scan_chunk`` epochs a program (``--scan-chunk``). Here the same
chunk loop runs them through ``TrainScan``: on the card one captured CUDA
graph a chunk length, replayed (the capturable Adam of
``make_optimizer``, its lr a device scalar); on the CPU the loop of the
eager step, the twin the tests use. An epoch that stands alone between
boundaries runs the eager step, as in JAX. Any chunking gives the same
model, bitwise on the CPU. Training routes, chosen as JAX chooses
(``choose_propagation`` and the eval layout):

- dense: the normalized (U, I) incidence through ``ops/propagation``;
- the kernel route: on CUDA with ``compute.use_pallas`` (read as "use the
  hand-written kernels"), the bfloat16 preset and the kernel's guard, the
  int8 binary incidence through the ``dual_matmul`` kernel
  (``ops/cuda/propagation``), at any catalog that takes the dense side
  (JAX's TPU kernel also needs its VMEM guard, ``fits_vmem_binary``; past
  it JAX takes the rung);
- the bf16-dense rung: a bf16 incidence built on the device
  (``data/graph.device_bf16_incidence``) where the f32 one would pass
  ``HOST_INCIDENCE_BUILD_BYTES``;
- COO: past the 4 GB incidence budget or below ``compute.dense_threshold``,
  the layer mean over the edge list with its self-adjoint backward: on
  CUDA with ``compute.use_pallas`` and f32 tables, one ``segment_pair``
  kernel launch a layer over the edges sorted by destination
  (``ops/cuda/segment_propagation``); otherwise the bucketed-ELL layout
  (``ops/propagation.lightgcn_propagate_bucketed``), which JAX's COO route
  mirrors. The step asks the operand for its propagation
  (``SegmentGraph.propagate``, ``BucketedIncidence.propagate``).

Where the f32 (U, I) eval arrays would pass ``DENSIFY_BUDGET_BYTES`` (and on
every COO run), nothing but the train incidence is O(U*I): negatives are
rejected against CSR keys, the val loss runs the COO propagation, and
evaluation ranks in user chunks with CSR masks (``ops/scalable``).

RNG: torch cannot reproduce ``jax.random``. Each epoch draws from its own
generator seeded from (seed, epoch) (``epoch_seed``), the counterpart of
``fold_in(key, e)``; the val draw at eval epoch e uses (seed, epochs + e).
The stream does not depend on where a run stopped, so a resumed run draws
the uninterrupted run's triples, and the CSR samplers draw the dense
samplers' triples.

The mesh branch (``train_lightgcn_on_mesh``, ``lgcnhs_tpu/train/trainer.py:
422-470,552-633,675-868``): with ``compute.mesh_shape`` resolved to a mesh
(``runtime/mesh.mesh_from_config``), the tables and Adam's moments are
row-sharded and padded, the incidence and the positives item-sharded, the
edges replicated at their true length (the single-device triple stream),
the step is ``parallel/sharding.make_sharded_train_step`` (``dual_matmul``
on each rank's int8 item block on the kernel route) and the evaluation
ranks through the distributed masked top-k. A graph that takes the COO
propagation shards its edge list over every rank instead, with the tables
whole on every rank or, with ``compute.coo_table_sharding``, row-sharded,
and evaluates through the user-sharded CSR top-k. The mesh runs one eager
step an epoch in the same chunk loop; its scans are loops
(``parallel/sharding``).
"""
from __future__ import annotations

import os
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.graph import (
    EdgeSet,
    InteractionGraph,
    binary_incidence_factors,
    degree_inv_sqrt,
    device_bf16_incidence,
    interaction_matrix,
    item_degrees,
    normalized_bipartite,
    pos_bool_matrix,
    unique_edges,
    user_pos_counts,
    users_present,
)
from lgcnhs_tpu_torch.models.lightgcn import (
    LightGCNParams,
    bpr_loss,
    init_lightgcn,
    init_lightgcn_opti,
    layer0_scores,
    sample_bpr_batch,
    sample_negatives_for_edges,
)
from lgcnhs_tpu_torch.ops import metrics_ops
from lgcnhs_tpu_torch.ops.cuda.launches import add_replays, capture_tally
from lgcnhs_tpu_torch.ops.cuda.propagation import (
    fits_dual,
    lightgcn_propagate_dual,
    lightgcn_propagate_dual_binary,
    pad_for_dual,
    release_workspace,
)
from lgcnhs_tpu_torch.ops.cuda.segment_propagation import build_segment_graph
from lgcnhs_tpu_torch.ops.propagation import (
    build_bucketed_incidence,
    edge_gcn_norm,
    lightgcn_propagate,
    lightgcn_propagate_coo,
)
from lgcnhs_tpu_torch.ops.scalable import (
    chunked_masked_topk,
    csr_keys,
    hits_csr,
    internal_similarity_csr,
    sample_bpr_batch_csr,
    sample_negatives_for_edges_csr,
    user_csr,
)
from lgcnhs_tpu_torch.ops.topk import masked_topk
from lgcnhs_tpu_torch.runtime.device import resolve_device
from lgcnhs_tpu_torch.runtime.logging import get_logger, span, stage_timer
from lgcnhs_tpu_torch.runtime.mesh import (
    MODEL_AXIS, Mesh, col_sharded, is_writer, mesh_from_config, replicated, row_sharded,
)
from lgcnhs_tpu_torch.runtime.table import read_csv, write_csv
from lgcnhs_tpu_torch.train.checkpoint import (
    load_optimizer_state,
    optimizer_state,
    restore_train_state,
    save_train_state,
)

_TABLE_DTYPES = {"float32": torch.float32, "float64": torch.float64,
                 "bfloat16": torch.float32}  # bf16 = mixed precision, f32 tables
HISTORY_COLUMNS = ("iters", "train_loss", "val_loss", "val_precision", "val_recall",
                   "val_f1", "val_ndcg", "val_H", "val_I")


@dataclass
class TrainResult:
    params: LightGCNParams
    history: Dict[str, List[float]] = field(default_factory=dict)


def lr_schedule(lr0: float, gamma: float, decay_every: int):
    """Reference ExponentialLR stepped every ``decay_every`` epochs except
    epoch 0 (``train.py:180-181``): the lr of the update at ``step``."""

    def schedule(step: int) -> float:
        return lr0 * gamma ** max(0, (step - 1) // decay_every)

    return schedule


def make_optimizer(hp, params: LightGCNParams, capturable: bool = False) -> torch.optim.Adam:
    """``torch.optim.Adam(lr)`` over the two tables, the reference's
    optimizer; the train step sets each update's lr from ``lr_schedule``
    (the reference's ExponentialLR; ``docs/PARITY.md`` section 2.6 pins
    optax Adam to this pair). ``capturable`` (the card's graph route,
    ``TrainScan``): Adam's step count and bias corrections on the tables'
    device, and its lr a device scalar that each update writes in place,
    so that an update can be captured into a CUDA graph. Its state is made
    here, as Adam's first step would make it but for the step count, which
    is float64 (Adam's own is float32): the bias corrections and the lr
    are then taken in double on the device, as the default Adam takes them
    on the host, and rounded to f32 where the update uses them. What is
    left between the two is the update's order of operations (the
    capturable Adam divides the denominator by the step size, the default
    multiplies by it)."""
    tables = [params.user_emb, params.item_emb]
    if not capturable:
        return torch.optim.Adam(tables, lr=hp.lr)
    device = params.user_emb.device
    lr = torch.tensor(hp.lr, dtype=torch.float64, device=device)
    optimizer = torch.optim.Adam(tables, lr=lr, capturable=True)
    for t in tables:
        optimizer.state[t] = {"step": torch.zeros((), dtype=torch.float64, device=device),
                              "exp_avg": torch.zeros_like(t), "exp_avg_sq": torch.zeros_like(t)}
    return optimizer


def _set_lr(optimizer, lr) -> None:
    """Every group's lr: a float, or written into a capturable optimizer's
    device scalar (from a float, or a device value inside a graph)."""
    for group in optimizer.param_groups:
        if not torch.is_tensor(group["lr"]):
            group["lr"] = lr
        elif torch.is_tensor(lr):
            group["lr"].copy_(lr)
        else:
            group["lr"].fill_(lr)


def epoch_seed(seed: int, epoch: int) -> int:
    """Seed of epoch ``epoch``'s generator: (seed, epoch) packed in 64 bits."""
    return ((seed & 0xFFFFFFFF) << 32) | (epoch & 0xFFFFFFFF)


def epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(epoch_seed(seed, epoch))
    return g


def _bpr_of_finals(params, u_final, i_final, users, pos_items, neg_items, epsilon):
    """BPR of one batch from the propagated tables and the layer-0 rows."""
    return bpr_loss(
        u_final[users], params.user_emb[users],
        i_final[pos_items], params.item_emb[pos_items],
        i_final[neg_items], params.item_emb[neg_items],
        epsilon,
    )


def _loss_fn(params, R_hat, users, pos_items, neg_items, epsilon, n_layers,
             bf16_matmul=False, use_kernel=False):
    """BPR loss of one batch over the full-graph forward. ``use_kernel``
    plays JAX's ``use_pallas``: with ``bf16_matmul`` and the kernel's guard
    it propagates through ``dual_matmul`` (the kernel on CUDA, its twin on
    the CPU). R_hat is the dense incidence or the factored triple
    (R int8, du^-1/2, di^-1/2) of ``data/graph.binary_incidence_factors``
    (``device_binary_factors``; the kernel route pads R's rows once,
    ``pad_for_dual``)."""
    D = params.user_emb.shape[1]
    if isinstance(R_hat, tuple):
        R8, du_inv, di_inv = R_hat
        if use_kernel and bf16_matmul and fits_dual(D, R8.device):
            u_final, i_final = lightgcn_propagate_dual_binary(
                params.user_emb, params.item_emb, R8, du_inv, di_inv, n_layers, True,
            )
        else:  # correctness fallback; the trainer picks the tuple only for the kernel
            dense = du_inv[:, None] * R8.to(du_inv.dtype) * di_inv[None, :]
            u_final, i_final = lightgcn_propagate(
                params.user_emb, params.item_emb, dense, n_layers, bf16_matmul
            )
    elif use_kernel and bf16_matmul and fits_dual(D, R_hat.device):
        u_final, i_final = lightgcn_propagate_dual(
            params.user_emb, params.item_emb, R_hat, n_layers, True
        )
    else:
        u_final, i_final = lightgcn_propagate(
            params.user_emb, params.item_emb, R_hat, n_layers, bf16_matmul
        )
    return _bpr_of_finals(params, u_final, i_final, users, pos_items, neg_items, epsilon)


#: Whether ``train_lightgcn`` runs the epochs between its boundaries
#: through ``make_train_scan`` / ``make_coo_train_scan`` (captured CUDA
#: graphs on the card, the step's loop on the CPU), as JAX runs its scan.
#: False runs one eager step an epoch with the default Adam, the route the
#: graphs are held against on the card (``chip_smoke.py`` phase 14).
CUDA_GRAPHS = True
#: Device-memory budget of a dense (U, I) incidence / f32 eval-array set,
#: the JAX trainer's 4 GB. Tests shrink it to pin the routes.
DENSIFY_BUDGET_BYTES = 4e9
#: above this f32-incidence size the bf16 preset trains on the bf16-dense
#: rung, its incidence built on the device (``device_bf16_incidence``).
HOST_INCIDENCE_BUILD_BYTES = 2e9


def choose_propagation(n_users: int, n_items: int, n_edges: int, compute,
                       single_chip: Optional[bool] = None) -> str:
    """"dense" or "coo", the rule of the JAX trainer: COO when the dense
    incidence (2 bytes an entry under bfloat16 on one device, else 4) would
    exceed ``DENSIFY_BUDGET_BYTES`` or its density is below
    ``compute.dense_threshold``. The bf16 expansion is single-device only:
    the mesh builds its sharded arrays on the host at f32 width.
    ``single_chip`` is whether no mesh resolved, which both trainers pass;
    by default (JAX's signature) the ``mesh_shape == (1, 1)`` proxy."""
    if single_chip is None:
        single_chip = tuple(getattr(compute, "mesh_shape", (1, 1))) == (1, 1)
    bf16 = getattr(compute, "dtype", "") == "bfloat16"
    entry_bytes = 2.0 if bf16 and single_chip else 4.0
    density = n_edges / max(1.0, float(n_users) * n_items)
    if entry_bytes * n_users * n_items > DENSIFY_BUDGET_BYTES or density < compute.dense_threshold:
        return "coo"
    return "dense"


def uses_kernels(compute, device: torch.device) -> bool:
    """Whether training may take the hand-written kernels: ``use_pallas``
    on a CUDA device (off CUDA every route is plain PyTorch, as JAX off the
    TPU)."""
    return bool(compute.use_pallas) and device.type == "cuda"


def _make_update(optimizer, sample, loss_of):
    """One epoch's work: sample -> forward -> BPR -> Adam update, as
    ``update(params, generator, lr, graph_op, edge_users, edge_items,
    rejection) -> loss`` (detached, before the update); ``lr`` as
    ``_set_lr`` takes it."""

    def update(params, generator, lr, graph_op, edge_users, edge_items, rejection):
        users, pos_items, neg_items = sample(generator, edge_users, edge_items, rejection)
        optimizer.zero_grad(set_to_none=True)
        loss = loss_of(params, graph_op, users, pos_items, neg_items)
        loss.backward()
        _set_lr(optimizer, lr)
        optimizer.step()
        return loss.detach()

    return update


def _make_step(optimizer, hp, sample, loss_of):
    """One epoch at its lr, as ``train_step(params, epoch, generator,
    graph_op, edge_users, edge_items, rejection) -> loss``."""
    return _epoch_step(hp, _make_update(optimizer, sample, loss_of))


def _epoch_step(hp, update):
    schedule = lr_schedule(hp.lr, hp.gamma, hp.epoch_per_lr_decay)

    def train_step(params, epoch, generator, *step_rest):
        return update(params, generator, schedule(epoch), *step_rest)

    return train_step


def _tensors(x):
    """The tensors in ``x``, through nested tuples and lists."""
    if torch.is_tensor(x):
        yield x
    elif isinstance(x, (tuple, list)):
        for y in x:
            yield from _tensors(y)


class _Captured(NamedTuple):
    """One captured chunk length."""

    graph: torch.cuda.CUDAGraph
    generators: List[torch.Generator]  # one an epoch, registered with the graph
    lrs: torch.Tensor  # the epochs' rates, read by the graph
    loss: torch.Tensor  # the last epoch's loss, written by the graph
    tally: Counter  # the launches its capture noted (ops/cuda/launches)
    addresses: List[int]  # of the tables and step_rest it was captured on


class TrainScan:
    """``train_scan(params, seed, epoch0, n_steps, *step_rest) -> loss``:
    epochs ``epoch0 .. epoch0 + n_steps - 1`` of a step's update, epoch e
    drawing from ``epoch_generator(seed, e)`` at ``lr_schedule``'s rate of
    e, the last epoch's loss returned (detached). The port of JAX
    ``make_train_scan``'s ``lax.scan``: any chunking gives the model
    ``n_steps`` calls of the step give.

    - On CUDA: one ``torch.cuda.CUDAGraph`` a chunk length (JAX's static
      ``n_steps``: one program a length), captured on a side stream at the
      first call of that length and replayed for it and every later one.
      Before each replay the graph's ``n_steps`` generators (registered
      with it) are seeded with their epochs' seeds, and the epochs' rates
      are copied into the lr vector that each captured update copies into
      Adam's lr. The scan's first call runs its first epoch eagerly on the
      side stream, so that what the update makes on its first use there
      (the kernels' split-K workspace, cuBLAS's) is made outside every
      graph's pool, and captures the rest. The optimizer must be
      ``make_optimizer(..., capturable=True)``'s, its state made; the
      tables and ``step_rest`` must be the tensors a graph was captured on
      (it holds their addresses). A failed capture raises. A kernel's
      launches inside a graph count at each replay
      (``ops/cuda/launches``). ``captures`` lists (n_steps, seconds) of
      each capture; ``release()`` frees the graphs and their pools.
    - On the CPU: the loop of the update, the twin the tests use.

    Spans (``runtime/logging.span``): the host's work of a replay (the
    re-seeds, the lr copy, the replay, the counts), or the CPU's loop, is
    ``train.replay``; a capture ``train.capture``, the eager first epoch
    ``train.first_epoch``. None is opened while a graph captures.
    """

    def __init__(self, optimizer, hp, update):
        self._optimizer = optimizer
        self._update = update
        self._schedule = lr_schedule(hp.lr, hp.gamma, hp.epoch_per_lr_decay)
        self._graphs: Dict[int, _Captured] = {}
        self._stream = None
        self.captures: List[tuple] = []

    def __call__(self, params, seed: int, epoch0: int, n_steps: int, *step_rest):
        if n_steps < 1:
            raise ValueError(f"train_scan: n_steps must be >= 1 (got {n_steps})")
        device = params.user_emb.device
        if device.type != "cuda":
            with span("train.replay"):
                for e in range(epoch0, epoch0 + n_steps):
                    loss = self._update(params, epoch_generator(seed, e, device),
                                        self._schedule(e), *step_rest)
            return loss
        if self._stream is None:
            with span("train.first_epoch"):
                loss = self._first_epoch(params, seed, epoch0, step_rest)
            epoch0, n_steps = epoch0 + 1, n_steps - 1
            if n_steps == 0:
                return loss
        cap = self._graphs.get(n_steps) or self._capture(params, n_steps, step_rest)
        if [t.data_ptr() for t in _tensors((params, step_rest))] != cap.addresses:
            raise ValueError("train_scan: called on other tensors than its graph of "
                             f"{n_steps} epochs was captured on")
        epochs = range(epoch0, epoch0 + n_steps)
        with span("train.replay"):
            for g, e in zip(cap.generators, epochs):
                g.manual_seed(epoch_seed(seed, e))
            cap.lrs.copy_(torch.tensor([self._schedule(e) for e in epochs],
                                       dtype=cap.lrs.dtype))
            cap.graph.replay()
            add_replays(cap.tally)
        return cap.loss.clone()

    def _first_epoch(self, params, seed: int, epoch: int, step_rest):
        opt = self._optimizer
        if not all(group.get("capturable") for group in opt.param_groups) \
                or not all(opt.state.get(t) for t in params):
            raise ValueError("train_scan on CUDA needs a capturable optimizer with its state: "
                             "make_optimizer(hp, params, capturable=True)")
        device = params.user_emb.device
        current = torch.cuda.current_stream(device)
        self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            loss = self._update(params, epoch_generator(seed, epoch, device),
                                self._schedule(epoch), *step_rest)
        current.wait_stream(self._stream)
        loss.record_stream(current)
        return loss

    def _capture(self, params, n_steps: int, step_rest) -> _Captured:
        t0 = time.perf_counter()
        device = params.user_emb.device
        with span("train.capture"):
            generators = [torch.Generator(device=device) for _ in range(n_steps)]
            lrs = torch.empty(n_steps, dtype=self._optimizer.param_groups[0]["lr"].dtype,
                              device=device)
            graph = torch.cuda.CUDAGraph()
            for g in generators:
                graph.register_generator_state(g)
            with capture_tally() as tally, torch.cuda.graph(graph, stream=self._stream):
                for k in range(n_steps):
                    loss = self._update(params, generators[k], lrs[k], *step_rest)
        cap = self._graphs[n_steps] = _Captured(
            graph, generators, lrs, loss, tally,
            [t.data_ptr() for t in _tensors((params, step_rest))])
        self.captures.append((n_steps, time.perf_counter() - t0))
        return cap

    def release(self) -> None:
        """Frees the captured graphs (their pools) and the capture stream's
        kernel workspace."""
        if self._stream is not None:
            torch.cuda.synchronize(self._stream.device)
            release_workspace(self._stream)
        for cap in self._graphs.values():
            cap.graph.reset()
        self._graphs.clear()
        self._stream = None


def _dense_update(optimizer, hp, n_items: int, bf16_matmul: bool, use_kernel: bool,
                  neg_hi: Optional[int], csr_sampler: bool):
    """``make_train_step``'s update (``_make_update``); the sampler is looked
    up in this module when it is called."""
    hi = neg_hi if neg_hi is not None else n_items

    def sample(generator, edge_users, edge_items, rejection):
        sampler = sample_bpr_batch_csr if csr_sampler else sample_bpr_batch
        return sampler(generator, edge_users, edge_items, rejection, hp.batch_size, hi)

    def loss_of(params, R_hat, users, pos_items, neg_items):
        return _loss_fn(params, R_hat, users, pos_items, neg_items, hp.epsilon, hp.layers,
                        bf16_matmul, use_kernel)

    return _make_update(optimizer, sample, loss_of)


def make_train_step(optimizer, hp, n_items: int, bf16_matmul: bool = False,
                    use_kernel: bool = False, neg_hi: Optional[int] = None,
                    csr_sampler: bool = False):
    """The dense-incidence step (``_loss_fn``). ``neg_hi`` bounds the
    negative candidates (``n_items`` by default; ``hparams.neg_range=
    'reference'`` passes the split-bounded range). The step's rejection
    argument is the (U, I) ``pos_mask``, or with ``csr_sampler`` the CSR keys
    of ``ops/scalable.csr_keys`` (the same triples; the kernel route and the
    rung use it where the eval arrays do not fit)."""
    return _epoch_step(hp, _dense_update(optimizer, hp, n_items, bf16_matmul, use_kernel,
                                         neg_hi, csr_sampler))


def make_train_scan(optimizer, hp, n_items: int, bf16_matmul: bool = False,
                    use_kernel: bool = False, neg_hi: Optional[int] = None,
                    csr_sampler: bool = False) -> TrainScan:
    """``make_train_step`` over ``n_steps`` epochs (JAX ``make_train_scan``):
    ``train_scan(params, seed, epoch0, n_steps, graph_op, edge_users,
    edge_items, rejection) -> the last epoch's loss``, the model of
    ``n_steps`` calls of the step (``TrainScan``: a CUDA graph on the card,
    the step's loop on the CPU)."""
    return TrainScan(optimizer, hp, _dense_update(optimizer, hp, n_items, bf16_matmul,
                                                  use_kernel, neg_hi, csr_sampler))


def _coo_update(optimizer, hp, n_items: int, neg_hi: Optional[int]):
    """``make_coo_train_step``'s update (``_make_update``); the sampler is
    looked up in this module when it is called."""
    hi = neg_hi if neg_hi is not None else n_items

    def sample(generator, edge_users, edge_items, keys):
        return sample_bpr_batch_csr(generator, edge_users, edge_items, keys, hp.batch_size, hi)

    def loss_of(params, graph_op, users, pos_items, neg_items):
        u_final, i_final = graph_op.propagate(params.user_emb, params.item_emb, hp.layers)
        return _bpr_of_finals(params, u_final, i_final, users, pos_items, neg_items,
                              hp.epsilon)

    return _make_update(optimizer, sample, loss_of)


def make_coo_train_step(optimizer, hp, n_items: int, neg_hi: Optional[int] = None):
    """The large-graph step (JAX ``make_coo_train_step``): the forward and
    the backward through the graph operand's own propagation, the
    ``segment_pair`` kernel's ``SegmentGraph`` or the bucketed incidence of
    ``build_bucketed_incidence`` (gathers and sums only, nothing scatters),
    negatives rejected against CSR keys; the edges keep their original
    order, so the triples are the dense sampler's."""
    return _epoch_step(hp, _coo_update(optimizer, hp, n_items, neg_hi))


def make_coo_train_scan(optimizer, hp, n_items: int, neg_hi: Optional[int] = None) -> TrainScan:
    """``make_coo_train_step`` over ``n_steps`` epochs (JAX
    ``make_coo_train_scan``): ``train_scan(params, seed, epoch0, n_steps,
    graph_op, edge_users, edge_items, keys)`` (``TrainScan``)."""
    return TrainScan(optimizer, hp, _coo_update(optimizer, hp, n_items, neg_hi))


@torch.no_grad()
def val_loss_fn(params, R_hat_val, users, pos_items, neg_items, epsilon, n_layers):
    """Reference ``calValLoss``: forward on the VAL adjacency at the tables'
    precision (never the kernel route), BPR over all val edges
    (``model/LightGCN/evaluation.py:56-86``)."""
    return _loss_fn(params, R_hat_val, users, pos_items, neg_items, epsilon, n_layers)


@torch.no_grad()
def coo_val_loss_fn(params, edge_users, edge_items, edge_norm, users, pos_items, neg_items,
                    epsilon, n_layers):
    """``val_loss_fn`` over the val edge list: the forward is the COO
    propagation with ``edge_gcn_norm`` weights (JAX ``_coo_val_loss``)."""
    u_final, i_final = lightgcn_propagate_coo(
        params.user_emb, params.item_emb, edge_users, edge_items, edge_norm,
        params.user_emb.shape[0], params.item_emb.shape[0], n_layers,
    )
    return _bpr_of_finals(params, u_final, i_final, users, pos_items, neg_items, epsilon)


@torch.no_grad()
def _val_eval(params, train_pos, val_pos, val_counts, val_present, train_interaction,
              train_deg, k, n_items):
    """Val recommendations (layer-0 scores, train positives masked) and the
    five computed metrics (F1 is derived from P and R)."""
    rec = masked_topk(layer0_scores(params), train_pos, k)
    p, r = metrics_ops.precision_recall(rec, val_pos, val_counts, val_present)
    n = metrics_ops.ndcg_at_k(rec, val_pos, val_present)
    h = metrics_ops.hamming_distance(rec, n_items)
    i = metrics_ops.internal_similarity(rec, train_interaction, train_deg)
    return rec, p, r, n, h, i


def device_binary_factors(n_users: int, n_items: int, es: EdgeSet, device):
    """``data/graph.binary_incidence_factors`` built on ``device`` from the
    edge arrays, with the same values: (R int8 0/1, du^-1/2 f32,
    di^-1/2 f32), the binary degrees counted on the deduplicated edges and
    their inverse square roots taken in f64 (no (U, I) temporary beside R).
    The kernel route then pads R's rows (``pad_for_dual``)."""
    ded = unique_edges(es)
    users = torch.from_numpy(ded.users.astype(np.int64)).to(device)
    items = torch.from_numpy(ded.items.astype(np.int64)).to(device)
    R8 = torch.zeros((n_users, n_items), dtype=torch.int8, device=device)
    R8[users, items] = 1
    return R8, degree_inv_sqrt(users, n_users), degree_inv_sqrt(items, n_items)


def train_lightgcn(
    graph: InteractionGraph,
    cfg: Config,
    user_features: Optional[np.ndarray] = None,
    item_features: Optional[np.ndarray] = None,
    save_artifacts: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    device: torch.device | str = "cuda",
) -> TrainResult:
    """Train LightGCN (or LightGCNOpti when features are given) on
    ``device``: the card unless ``device="cpu"`` is asked for (raises
    without CUDA). Returns the final tables (detached, on ``device``) and
    the per-eval metric history (``train.py:107-177``). With
    ``checkpoint_dir`` the full training state is saved after every epoch
    e > 0 with e % ``checkpoint_every`` == 0, and the run resumes after
    the newest checkpoint found there (``lgcnhs_tpu/train/trainer.py:
    913-987,1027-1030``). Its set-up, up to the epoch loop, is a
    ``train.setup`` span."""
    hp = cfg.hparams
    log = get_logger()
    device = resolve_device(device)
    U, I = graph.n_users, graph.n_items
    mesh = mesh_from_config(cfg.compute)
    if mesh is not None:
        if mesh.device.type != device.type:
            raise ValueError(f"the mesh's ranks run on {mesh.device.type}, device= asks for "
                             f"{device.type}")
        return train_lightgcn_on_mesh(graph, cfg, mesh, user_features, item_features,
                                      save_artifacts, checkpoint_dir, checkpoint_every)
    # opened and closed by hand, so that the set-up keeps its indentation;
    # an exception ends the range when the frame lets it go
    setup = span("train.setup").__enter__()
    if cfg.compute.coo_table_sharding:
        raise ValueError(
            "compute.coo_table_sharding requires a resolved mesh (--mesh); "
            "without one, tables are single-device anyway"
        )
    dtype, np_dtype = _dtypes(cfg)
    params, model_name = _init_params(graph, cfg, user_features, item_features, device, dtype)
    params = LightGCNParams(*(t.requires_grad_(True) for t in params))

    _bf16 = cfg.compute.dtype == "bfloat16"
    _kernel = uses_kernels(cfg.compute, device)
    # no mesh resolved (``--mesh auto`` on one rank included): single device
    propagation = choose_propagation(U, I, graph.train.n_edges, cfg.compute, single_chip=True)
    # the eval layout is chosen apart from the train propagation: the
    # kernel route and the rung train on a 1- or 2-byte incidence at
    # catalogs whose f32 (U, I) eval arrays would not fit
    eval_dense = propagation == "dense" and 4.0 * U * I <= DENSIFY_BUDGET_BYTES

    # LightGCN-side edge lists are DEDUPED (utils/graph.py:23-25); the
    # metric side keeps the raw rows (item_degrees / user_pos_counts)
    train_es = unique_edges(graph.train)
    val_es = unique_edges(graph.val)

    def edges(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    def dense(a, dt=None):
        return torch.from_numpy(a).to(device, dt)

    edge_users, edge_items = edges(train_es.users), edges(train_es.items)
    val_edge_users, val_edge_items = edges(val_es.users), edges(val_es.items)
    val_counts = dense(user_pos_counts(U, graph.val))
    val_present = dense(users_present(U, graph.val))

    neg_hi_train, neg_hi_val, val_reject_uid = _negative_ranges(graph, hp)

    if propagation == "coo":
        edge_norm = edge_gcn_norm(edge_users, edge_items, U, I)
        if _kernel and dtype == torch.float32:
            graph_op = build_segment_graph(edge_users, edge_items, edge_norm, U, I)
            layout = "one segment_pair CUDA kernel a layer over the sorted edges"
        else:
            graph_op = build_bucketed_incidence(train_es.users, train_es.items,
                                                edge_norm.cpu().numpy(), U, I, device=device)
            layout = "bucketed-ELL aggregation"
        log.info("training %s: graph too large/sparse to densify, COO propagation (%s) on %s",
                 model_name, layout, device)
    elif _kernel and _bf16 and fits_dual(hp.embedding_dim, device):
        R8, du_inv, di_inv = device_binary_factors(U, I, graph.train, device)
        # the kernel reads R's rows in 16-byte copies; the incidence is
        # constant, so its padded-stride copy is built once for the run
        graph_op = (pad_for_dual(R8), du_inv, di_inv)
        del R8
        log.info("training %s: int8 binary incidence through the dual_matmul CUDA kernel",
                 model_name)
    elif _bf16 and 4.0 * U * I > HOST_INCIDENCE_BUILD_BYTES:
        graph_op = device_bf16_incidence(U, I, graph.train, device)
        log.info("training %s: bf16-dense rung (bf16 incidence built on %s)", model_name,
                 device)
    else:
        graph_op = dense(normalized_bipartite(U, I, graph.train, dtype=np_dtype),
                         torch.bfloat16 if _bf16 else dtype)
        log.info("training %s: plain dense propagation (%s incidence) on %s",
                 model_name, "bf16" if _bf16 else cfg.compute.dtype, device)

    if eval_dense:
        R_hat_val = dense(normalized_bipartite(U, I, graph.val, dtype=np_dtype), dtype)
        train_pos = dense(pos_bool_matrix(U, I, graph.train))
        val_pos = dense(pos_bool_matrix(U, I, graph.val))
        train_interaction = dense(interaction_matrix(U, I, graph.train))
        train_deg = dense(item_degrees(I, graph.train))
        rejection = train_pos

        def val_loss(params, generator):
            v_users, v_pos, v_neg = sample_negatives_for_edges(
                generator, val_edge_users, val_edge_items, val_pos, neg_hi_val,
                reject_user_ids=val_reject_uid,
            )
            return val_loss_fn(params, R_hat_val, v_users, v_pos, v_neg, hp.epsilon,
                               hp.layers)

        def eval_fn(params):
            return _val_eval(params, train_pos, val_pos, val_counts, val_present,
                             train_interaction, train_deg, cfg.k, I)[1:]
    else:
        # NOTHING here is O(U*I): rejection, masks, hits and the Sorensen
        # metric run against CSR structures, retrieval in user chunks
        log.info("evaluating %s on the CSR structures (f32 (U, I) eval arrays: %.3g bytes)",
                 model_name, 4.0 * U * I)
        rowptr, cols = user_csr(U, train_es)
        rejection = csr_keys(rowptr, cols, device)
        v_keys = csr_keys(*user_csr(U, val_es), device)
        val_edge_norm = edge_gcn_norm(val_edge_users, val_edge_items, U, I)
        csr_metrics = _csr_metrics(graph, v_keys, device)

        def val_loss(params, generator):
            # every val edge exactly once (calValLoss, evaluation.py:68-77)
            v_users, v_pos, v_neg = sample_negatives_for_edges_csr(
                generator, val_edge_users, val_edge_items, v_keys, neg_hi_val,
                reject_user_ids=val_reject_uid,
            )
            return coo_val_loss_fn(params, val_edge_users, val_edge_items, val_edge_norm,
                                   v_users, v_pos, v_neg, hp.epsilon, hp.layers)

        @torch.no_grad()
        def eval_fn(params):
            return csr_metrics(chunked_masked_topk(params.user_emb, params.item_emb, rowptr,
                                                   cols, cfg.k))

    optimizer = make_optimizer(hp, params, capturable=CUDA_GRAPHS and device.type == "cuda")
    if propagation == "coo":
        make_step, make_scan, kw = make_coo_train_step, make_coo_train_scan, {}
    else:
        make_step, make_scan = make_train_step, make_train_scan
        kw = {"bf16_matmul": _bf16, "use_kernel": _kernel, "csr_sampler": not eval_dense}
    train_step = make_step(optimizer, hp, I, neg_hi=neg_hi_train, **kw)
    train_scan = make_scan(optimizer, hp, I, neg_hi=neg_hi_train, **kw) if CUDA_GRAPHS else None
    step_rest = (graph_op, edge_users, edge_items, rejection)
    log.info("training %s: epochs between evaluations and checkpoints %s, at most %s a chunk",
             model_name, "one eager step each" if train_scan is None else
             "as captured CUDA graphs" if device.type == "cuda" else "as the step's loop",
             cfg.compute.scan_chunk if cfg.compute.scan_chunk > 0 else "an interval")

    start_epoch = 0
    restored = restore_train_state(checkpoint_dir, device) if checkpoint_dir else None
    if restored is not None:
        last, saved, opt_state = restored
        with torch.no_grad():
            for table, value in zip(params, saved):
                if value.shape != table.shape or value.dtype != table.dtype:
                    raise ValueError(
                        f"checkpoint in {checkpoint_dir} holds a {tuple(value.shape)} "
                        f"{value.dtype} table where this run trains {tuple(table.shape)} "
                        f"{table.dtype}")
                table.copy_(value)
        load_optimizer_state(optimizer, params, opt_state)
        start_epoch = last + 1
        log.info("resumed from checkpoint at epoch %d", last)

    history: Dict[str, List[float]] = {name: [] for name in HISTORY_COLUMNS}
    if start_epoch > 0 and save_artifacts:
        _carry_history(cfg, model_name, history, start_epoch)
    setup.__exit__(None, None, None)
    try:
        with stage_timer(f"{model_name} training done ({hp.epochs} epochs)", log):
            _train_epochs(
                cfg, log, history, device, start_epoch,
                lambda epoch, gen: train_step(params, epoch, gen, *step_rest),
                lambda gen: val_loss(params, gen), lambda: eval_fn(params),
                checkpoint_every if checkpoint_dir else 0,
                lambda epoch: save_train_state(checkpoint_dir, epoch, params,
                                               optimizer_state(optimizer, params)),
                scan=None if train_scan is None else
                lambda e0, n: train_scan(params, hp.seed, e0, n, *step_rest))
    finally:
        if train_scan is not None:
            if train_scan.captures:
                log.info("training %s: captured graphs (epochs, seconds) %s", model_name,
                         train_scan.captures)
            train_scan.release()

    params = LightGCNParams(params.user_emb.detach(), params.item_emb.detach())
    _save_artifacts(cfg, model_name, params, history, save_artifacts)
    return TrainResult(params=params, history=history)


def _dtypes(cfg: Config):
    """(table torch dtype, numpy dtype of the host-built incidences)."""
    if cfg.compute.dtype not in _TABLE_DTYPES:
        raise ValueError(f"unknown compute.dtype {cfg.compute.dtype!r}")
    dtype = _TABLE_DTYPES[cfg.compute.dtype]
    return dtype, (np.float64 if dtype == torch.float64 else np.float32)


def _init_params(graph, cfg: Config, user_features, item_features, device, dtype):
    """(initial tables on ``device``, detached copies, model name): the
    LightGCNOpti feature projection when both feature tables are given, else
    LightGCN's N(0, 0.1^2), drawn on the CPU from ``hparams.seed``."""
    hp = cfg.hparams
    init_gen = torch.Generator().manual_seed(hp.seed)
    if user_features is not None and item_features is not None:
        params = init_lightgcn_opti(init_gen, user_features, item_features,
                                    hp.embedding_dim, device, dtype)
        model_name = "LightGCNOpti"
    else:
        params = init_lightgcn(init_gen, graph.n_users, graph.n_items, hp.embedding_dim,
                               device, dtype)
        model_name = "LightGCN"
    return LightGCNParams(*(t.detach().clone().to(device, dtype) for t in params)), model_name


def _negative_ranges(graph, hp):
    """(train negatives' bound, val negatives' bound, reject the user's own
    id among val candidates): the catalog, or with ``neg_range='reference'``
    each split's max node id + 1 (``docs/PARITY.md`` deviation 6)."""
    I = graph.n_items
    if hp.neg_range == "reference":

        def _split_neg_hi(es, split_name: str) -> int:
            hi = 1 + int(max(np.asarray(es.users).max(initial=-1),
                             np.asarray(es.items).max(initial=-1)))
            if hi > I:
                raise ValueError(
                    f"neg_range='reference': the {split_name} split's max node id "
                    f"{hi - 1} >= n_items={I}; the reference's own sampler would index "
                    "items_emb out of range here (structured_negative_sampling bounds "
                    "candidates by the max USER-or-item id). Use neg_range='catalog'."
                )
            return hi

        return _split_neg_hi(graph.train, "train"), _split_neg_hi(graph.val, "val"), True
    if hp.neg_range == "catalog":
        return I, I, False
    raise ValueError(
        f"unknown hparams.neg_range {hp.neg_range!r} (expected 'catalog' or 'reference')"
    )


def _train_epochs(cfg: Config, log, history, device, start_epoch: int, step, val_loss, evaluate,
                  checkpoint_every: int, checkpoint, scan=None) -> None:
    """The epoch loop of both trainers, JAX's chunk loop
    (``lgcnhs_tpu/train/trainer.py:988-1025``): the epochs up to the next
    boundary (an eval epoch, every ``epoch_per_eval``, or a checkpoint
    epoch, every ``checkpoint_every`` but 0; 0 means never) run as one
    chunk, through ``scan(epoch0, n_epochs) -> loss`` in sub-chunks of at
    most ``compute.scan_chunk`` epochs (0: the whole chunk) when the chunk
    holds more than one epoch and a scan is given, else one
    ``step(epoch, generator) -> loss`` an epoch on the epoch's own
    generator. At the boundary: ``checkpoint(epoch)``, then on eval epochs
    ``val_loss(generator)`` on its generator and ``evaluate()``, recorded
    into ``history``. Each eager epoch is a ``train.step`` span, each
    boundary's parts ``train.checkpoint``, ``train.val_loss``,
    ``train.evaluate`` and ``train.record`` spans
    (``runtime/logging.span``)."""
    hp = cfg.hparams

    def is_boundary(e: int) -> bool:
        return e % hp.epoch_per_eval == 0 or bool(checkpoint_every and e
                                                 and e % checkpoint_every == 0)

    epoch = start_epoch
    while epoch < hp.epochs:
        last = epoch
        while last < hp.epochs - 1 and not is_boundary(last):
            last += 1
        if scan is not None and last > epoch:
            sub = max(0, cfg.compute.scan_chunk) or last + 1 - epoch
            for e0 in range(epoch, last + 1, sub):
                loss = scan(e0, min(sub, last + 1 - e0))
        else:
            for e in range(epoch, last + 1):
                with span("train.step"):
                    loss = step(e, epoch_generator(hp.seed, e, device))
        epoch = last
        if checkpoint_every and epoch and epoch % checkpoint_every == 0:
            with span("train.checkpoint"):
                checkpoint(epoch)
        if epoch % hp.epoch_per_eval == 0:
            with span("train.val_loss"):
                vloss = val_loss(epoch_generator(hp.seed, hp.epochs + epoch, device))
            with span("train.evaluate"):
                metrics = evaluate()
            _record_eval(history, epoch, loss, vloss, metrics, cfg, log)
            del metrics  # device scalars, not to be held through the next interval
        epoch += 1


def _record_eval(history, epoch, loss, vloss, metrics, cfg: Config, log) -> None:
    """One eval row: the losses and the five metrics rounded to 5
    decimals, F1 of the rounded P and R, appended and logged. The reading
    and appending is a ``train.record`` span; the log call, whose handlers
    are the caller's, is not."""
    with span("train.record"):
        p, r, n, h, i = metrics
        tl, vl = round(float(loss), 5), round(float(vloss), 5)
        p, r, n = round(float(p), 5), round(float(r), 5), round(float(n), 5)
        f1 = round(2 * p * r / (p + r), 5) if (p + r) else 0.0
        h, i = round(float(h), 5), round(float(i), 5)
        for name, v in zip(HISTORY_COLUMNS, (epoch, tl, vl, p, r, f1, n, h, i)):
            history[name].append(v)
    log.info(
        "[Iteration %d/%d] train_loss: %s, val_loss: %s, val_precision@%d: %s, "
        "val_recall@%d: %s, val_f1@%d: %s, val_NDCG@%d: %s, val_H@%d: %s, "
        "val_I@%d: %s",
        epoch, cfg.hparams.epochs, tl, vl, cfg.k, p, cfg.k, r, cfg.k, f1, cfg.k, n,
        cfg.k, h, cfg.k, i,
    )


def _save_artifacts(cfg: Config, model_name: str, params: LightGCNParams, history,
                    save_artifacts: bool) -> None:
    """The final tables' npz checkpoint and the history, on the writing
    rank only."""
    if save_artifacts and is_writer():
        cfg.ensure_dirs()
        save_checkpoint(os.path.join(cfg.model_path, f"{cfg.k}_{model_name}.npz"), params)
        _save_history(cfg, model_name, history)


def train_lightgcn_on_mesh(
    graph: InteractionGraph,
    cfg: Config,
    mesh: Mesh,
    user_features: Optional[np.ndarray] = None,
    item_features: Optional[np.ndarray] = None,
    save_artifacts: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
) -> TrainResult:
    """``train_lightgcn`` on a resolved (data, model) mesh, every rank one
    call (``lgcnhs_tpu/train/trainer.py:422-470,552-633,675-868``): the same
    initial tables, triples, BPR, Adam and lr schedule as one device, each
    epoch in the single-device trainer's loop (``_train_epochs``), along the
    route ``choose_propagation`` picks with no bf16 expansion (the mesh
    builds its arrays at f32 width):

    - dense (``_mesh_dense_route``): the tables row-sharded and padded,
      the incidence item-sharded, ``make_sharded_train_step``, the
      distributed masked top-k evaluation;
    - COO (``_mesh_coo_route``): the edge list sharded over every rank, the
      tables whole on every rank (``make_sharded_coo_train_step``) or, with
      ``compute.coo_table_sharding``, row-sharded and padded
      (``make_table_sharded_coo_train_step``); the val loss by the COO
      propagation over the val edges, the CSR evaluation through the
      user-sharded ``make_distributed_csr_masked_topk``.

    ``coo_table_sharding`` on a graph that takes the dense route is logged
    and changes nothing (the dense plan row-shards the tables already), as
    in JAX. Adam's moments follow the tables. Every rank returns the whole
    tables on the mesh's device; rank 0 alone writes the checkpoint and
    history. With ``checkpoint_dir`` rank 0 saves the whole (padded) tables
    and moments and a resume cuts each rank's rows again."""
    from lgcnhs_tpu_torch.parallel import sharding

    hp = cfg.hparams
    log = get_logger()
    device = mesh.device
    U, I = graph.n_users, graph.n_items
    propagation = choose_propagation(U, I, graph.train.n_edges, cfg.compute, single_chip=False)
    if cfg.compute.coo_table_sharding and propagation != "coo":
        log.warning("coo_table_sharding requested but the graph takes the %s path; tables are "
                    "row-sharded by the dense mesh plan already: the flag has no additional "
                    "effect", propagation)
    sharded_tables = propagation == "dense" or bool(cfg.compute.coo_table_sharding)
    dtype, _ = _dtypes(cfg)
    params, model_name = _init_params(graph, cfg, user_features, item_features, "cpu", dtype)
    plan = sharding.make_plan(mesh)
    U_pad, I_pad = sharding.padded_catalog(plan, U, I) if sharded_tables else (U, I)
    params = (sharding.shard_params(plan, params) if sharded_tables
              else LightGCNParams(*(replicated(mesh, t) for t in params)))
    params = LightGCNParams(*(t.requires_grad_(True) for t in params))
    optimizer = make_optimizer(hp, params)
    group, n_model = mesh.group(MODEL_AXIS), mesh.shape[MODEL_AXIS]

    def whole(t: torch.Tensor) -> torch.Tensor:
        """A table (or moment) whole: joined over "model" when sharded."""
        t = t.detach()
        return sharding._gather_rows(t, group, n_model) if sharded_tables else t

    def mine(t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole table or moment."""
        return row_sharded(mesh, t) if sharded_tables else replicated(mesh, t)

    route = _mesh_coo_route if propagation == "coo" else _mesh_dense_route
    step, val_loss, evaluate = route(graph, cfg, mesh, plan, optimizer, params, (U_pad, I_pad),
                                     whole, log, model_name)

    start_epoch = 0
    restored = restore_train_state(checkpoint_dir, "cpu") if checkpoint_dir else None
    if restored is not None:
        last, saved, opt_state = restored
        want = ((U_pad, hp.embedding_dim), (I_pad, hp.embedding_dim))
        for table, value, shape in zip(params, saved, want):
            if tuple(value.shape) != shape or value.dtype != table.dtype:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir} holds a {tuple(value.shape)} "
                    f"{value.dtype} table where this mesh trains {shape} {table.dtype}"
                    + (" (padded to the model axis)" if sharded_tables else ""))
        with torch.no_grad():
            for table, value in zip(params, saved):
                table.copy_(mine(value))
        load_optimizer_state(optimizer, params, {
            name: {"step": s["step"], **{m: mine(s[m]) for m in ("exp_avg", "exp_avg_sq")}}
            for name, s in opt_state.items()})
        start_epoch = last + 1
        log.info("resumed from checkpoint at epoch %d", last)

    def checkpoint(epoch: int) -> None:
        tables = LightGCNParams(*(whole(t) for t in params))
        state = {name: {"step": s["step"], **{m: whole(s[m]) for m in ("exp_avg", "exp_avg_sq")}}
                 for name, s in optimizer_state(optimizer, params).items()}
        if is_writer():
            save_train_state(checkpoint_dir, epoch, tables, state)

    history: Dict[str, List[float]] = {name: [] for name in HISTORY_COLUMNS}
    if start_epoch > 0 and save_artifacts:
        _carry_history(cfg, model_name, history, start_epoch)
    with stage_timer(f"{model_name} training done ({hp.epochs} epochs)", log):
        _train_epochs(cfg, log, history, device, start_epoch, step, val_loss, evaluate,
                      checkpoint_every if checkpoint_dir else 0, checkpoint)

    params = sharding.unpad_params(params, U, I, mesh if sharded_tables else None)
    _save_artifacts(cfg, model_name, params, history, save_artifacts)
    return TrainResult(params=params, history=history)


def _mesh_dense_route(graph, cfg, mesh, plan, optimizer, params, padded, whole, log, model_name):
    """The mesh's dense route (``lgcnhs_tpu/train/trainer.py:552-633``):
    ``(step(epoch, generator), val_loss(generator), evaluate())`` over the
    row-sharded ``params``. The incidence (the factored int8 one on the
    ``dual_matmul`` route), the train and val positives, the val incidence
    and the train interaction padded and item-sharded, the edges
    replicated at their true length; the val loss over the sharded forward,
    the evaluation's layer-0 scores item-sharded and ranked by the
    distributed masked top-k, its metrics read from the sharded arrays."""
    from lgcnhs_tpu_torch.parallel import sharding

    hp = cfg.hparams
    device = mesh.device
    U, I = graph.n_users, graph.n_items
    U_pad, I_pad = padded
    dtype, np_dtype = _dtypes(cfg)
    _bf16 = cfg.compute.dtype == "bfloat16"
    kernel = uses_kernels(cfg.compute, device) and _bf16 and fits_dual(hp.embedding_dim, device)
    log.info("training %s on mesh %s (%s, %s)", model_name, mesh.shape, device,
             "int8 item blocks through the dual_matmul CUDA kernel" if kernel
             else f"dense {'bf16' if _bf16 else cfg.compute.dtype} item blocks")
    train_es, val_es = unique_edges(graph.train), unique_edges(graph.val)
    pos = pos_bool_matrix(U, I, graph.train)
    if kernel:
        (R8, du_inv, di_inv), train_pos, edge_users, edge_items = sharding.shard_train_inputs(
            plan, binary_incidence_factors(U, I, graph.train), pos, train_es.users,
            train_es.items)
        # the kernel reads R's rows in 16-byte copies: the padded-stride
        # copy of the rank's block, once for the run
        R_blk = (pad_for_dual(R8), du_inv, di_inv)
    else:
        R_blk, train_pos, edge_users, edge_items = sharding.shard_train_inputs(
            plan, normalized_bipartite(U, I, graph.train, dtype=np_dtype), pos,
            train_es.users, train_es.items, r_dtype=torch.bfloat16 if _bf16 else dtype)

    def cols(a, rows=U, fill=0):
        return col_sharded(mesh, torch.from_numpy(sharding._pad2(a, rows, I_pad, fill)))

    R_val = cols(normalized_bipartite(U, I, graph.val, dtype=np_dtype), U_pad).to(dtype)
    val_pos = cols(pos_bool_matrix(U, I, graph.val), fill=False)
    inter = cols(interaction_matrix(U, I, graph.train))
    deg = row_sharded(mesh, torch.from_numpy(sharding._pad1(item_degrees(I, graph.train),
                                                            I_pad)))
    val_users = replicated(mesh, torch.from_numpy(val_es.users.astype(np.int64)))
    val_items = replicated(mesh, torch.from_numpy(val_es.items.astype(np.int64)))
    val_counts = replicated(mesh, user_pos_counts(U, graph.val))
    val_present = replicated(mesh, users_present(U, graph.val))
    neg_hi_train, neg_hi_val, val_reject_uid = _negative_ranges(graph, hp)
    block = I_pad // mesh.shape[MODEL_AXIS]
    train_step = sharding.make_sharded_train_step(plan, optimizer, hp, I, bf16_matmul=_bf16,
                                                  neg_hi=neg_hi_train)

    def step(epoch, generator):
        return train_step(params, epoch, generator, R_blk, edge_users, edge_items, train_pos)

    @torch.no_grad()
    def val_loss(generator):
        # every val edge exactly once (calValLoss, evaluation.py:68-77)
        v_users, v_pos, v_neg = sample_negatives_for_edges(
            generator, val_users, val_items, sharding.ShardedColumns(mesh, val_pos),
            neg_hi_val, reject_user_ids=val_reject_uid)
        return sharding._sharded_bpr(mesh, params, R_val, v_users, v_pos, v_neg, hp.epsilon,
                                     hp.layers)

    @torch.no_grad()
    def evaluate():
        ue = whole(params.user_emb)[:U]
        rec = sharding._masked_topk_blocks(mesh, ue @ params.item_emb.detach().T,
                                           train_pos[:U], cfg.k, block)
        rows = torch.arange(U, device=device)[:, None].expand(U, cfg.k)
        hits = sharding.ShardedColumns(mesh, val_pos)[rows, rec.long()].to(torch.float32)
        p, r = metrics_ops.precision_recall_from_hits(hits, val_counts, val_present)
        n = metrics_ops.ndcg_from_hits(hits, val_present)
        h = metrics_ops.hamming_distance(rec, I)
        return p, r, n, h, sharding._internal_similarity_blocks(mesh, rec, inter, deg)

    return step, val_loss, evaluate


def _mesh_coo_route(graph, cfg, mesh, plan, optimizer, params, padded, whole, log, model_name):
    """The mesh's COO route (``lgcnhs_tpu/train/trainer.py:675-868``):
    ``(step(epoch, generator), val_loss(generator), evaluate())``. The
    edge list sharded over every rank in bucketed-ELL blocks built over the
    tables' (padded) sizes, the CSR keys and edges replicated (the
    single-device triples); the step ``make_sharded_coo_train_step``, or
    ``make_table_sharded_coo_train_step`` when the tables are row-sharded.
    The val loss and the evaluation read the whole tables: the val loss by
    the COO propagation over the val edges (the padded rows aggregate
    nothing), the evaluation through the user-sharded CSR top-k, staged
    once, on the true catalog ([:U], [:I]: padded rows never reach the
    scores), then the CSR hits and I@k on the gathered lists."""
    from lgcnhs_tpu_torch.parallel import sharding

    hp = cfg.hparams
    device = mesh.device
    U, I = graph.n_users, graph.n_items
    sharded_tables = bool(cfg.compute.coo_table_sharding)
    log.info("training %s on mesh %s (%s): graph too large/sparse to densify, COO propagation, "
             "edge-sharded bucketed-ELL aggregation, tables %s", model_name, mesh.shape, device,
             "row-sharded" if sharded_tables else "replicated")
    train_es, val_es = unique_edges(graph.train), unique_edges(graph.val)

    def edges(a):
        return replicated(mesh, torch.from_numpy(np.asarray(a, np.int64)))

    edge_users, edge_items = edges(train_es.users), edges(train_es.items)
    val_users, val_items = edges(val_es.users), edges(val_es.items)
    rowptr, cols = user_csr(U, train_es)
    keys = csr_keys(rowptr, cols, device)
    v_keys = csr_keys(*user_csr(U, val_es), device)
    edge_norm = edge_gcn_norm(edge_users, edge_items, U, I)
    se = sharding.shard_bucketed_incidence(plan, train_es.users, train_es.items,
                                           edge_norm.cpu().numpy(), *padded)
    neg_hi_train, neg_hi_val, val_reject_uid = _negative_ranges(graph, hp)
    make = (sharding.make_table_sharded_coo_train_step if sharded_tables
            else sharding.make_sharded_coo_train_step)
    train_step = make(plan, optimizer, hp, U, I, neg_hi=neg_hi_train)
    val_edge_norm = edge_gcn_norm(val_users, val_items, U, I)
    csr_topk = sharding.make_distributed_csr_masked_topk(mesh, rowptr, cols, U)
    csr_metrics = _csr_metrics(graph, v_keys, device)

    def tables():
        return LightGCNParams(*(whole(t) for t in params))

    def step(epoch, generator):
        return train_step(params, epoch, generator, se, edge_users, edge_items, keys)

    def val_loss(generator):
        # every val edge exactly once (calValLoss, evaluation.py:68-77)
        v_users, v_pos, v_neg = sample_negatives_for_edges_csr(
            generator, val_users, val_items, v_keys, neg_hi_val, reject_user_ids=val_reject_uid)
        return coo_val_loss_fn(tables(), val_users, val_items, val_edge_norm, v_users, v_pos,
                               v_neg, hp.epsilon, hp.layers)

    @torch.no_grad()
    def evaluate():
        ue, ie = tables()
        return csr_metrics(csr_topk(ue[:U], ie[:I], cfg.k))

    return step, val_loss, evaluate


def _csr_metrics(graph, v_keys, device):
    """``metrics(rec) -> (P, R, NDCG, H, I)`` of a (U, k) list on the CSR
    structures: hits against the val keys, I@k over the recommended items'
    Gram (``ops/scalable``)."""
    U, I = graph.n_users, graph.n_items
    val_counts = torch.from_numpy(user_pos_counts(U, graph.val)).to(device)
    val_present = torch.from_numpy(users_present(U, graph.val)).to(device)
    inter_edges = (np.asarray(graph.train.users), np.asarray(graph.train.items))
    train_deg_np = item_degrees(I, graph.train)

    def metrics(rec):
        hits = hits_csr(rec, v_keys)
        p, r = metrics_ops.precision_recall_from_hits(hits, val_counts, val_present)
        n = metrics_ops.ndcg_from_hits(hits, val_present)
        h = metrics_ops.hamming_distance(rec, I)
        i = internal_similarity_csr(rec, inter_edges, U, I, train_deg_np)
        return p, r, n, h, i

    return metrics


def save_checkpoint(path: str, params: LightGCNParams) -> None:
    """Final-params checkpoint as plain arrays (``user_emb``, ``item_emb``),
    the keys of ``lgcnhs_tpu/train/trainer.save_checkpoint``."""
    np.savez(
        path,
        user_emb=params.user_emb.detach().cpu().numpy(),
        item_emb=params.item_emb.detach().cpu().numpy(),
    )


def load_checkpoint(path: str, device: torch.device | str = "cpu") -> Optional[LightGCNParams]:
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return LightGCNParams(
            user_emb=torch.from_numpy(data["user_emb"]).to(device),
            item_emb=torch.from_numpy(data["item_emb"]).to(device),
        )


def _history_path(cfg: Config, model_name: str) -> str:
    return os.path.join(cfg.pictures_path, f"{model_name}_{cfg.k}_val_metrics.csv")


def _carry_history(cfg: Config, model_name: str, history: Dict[str, List[float]],
                   start_epoch: int) -> None:
    """On resume, the previous run's history rows with ``iters`` before
    ``start_epoch`` (``lgcnhs_tpu/train/trainer.py:963-986``), so the saved
    table covers the whole run; this run recomputes the rest. A missing file
    carries nothing; an unreadable one is logged and does not stop training."""
    path = _history_path(cfg, model_name)
    if not os.path.exists(path):
        return
    try:
        prior = read_csv(path)
        keep = [j for j, it in enumerate(prior["iters"]) if it < start_epoch]
        for name in history:
            if name in prior:
                history[name] = [prior[name][j] for j in keep]
        get_logger().info("resume: carried %d prior metric rows from %s", len(keep), path)
    except Exception as exc:  # a corrupt CSV must not stop training
        get_logger().warning("resume: could not carry prior history: %s", exc)


def _save_history(cfg: Config, model_name: str, history: Dict[str, List[float]]) -> None:
    """CSV (``runtime/table``, byte-identical to pandas'), and the metric
    curve PNGs where matplotlib imports (``train.py:190-221``)."""
    base = os.path.join(cfg.pictures_path, f"{model_name}_{cfg.k}")
    write_csv(_history_path(cfg, model_name), history)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        get_logger().info("matplotlib not installed: metric curves not plotted")
        return
    try:
        iters = history["iters"]
        fig = plt.figure()
        plt.plot(iters, history["train_loss"], label="train")
        plt.plot(iters, history["val_loss"], label="validation")
        plt.xlabel("iteration")
        plt.ylabel("loss")
        plt.title("training and validation loss curves")
        plt.legend()
        plt.savefig(base + "_loss_curves.png")
        plt.close(fig)
        for metric, label in (("val_precision", "precision"), ("val_recall", "recall"),
                              ("val_f1", "F1-score"), ("val_ndcg", "NDCG"),
                              ("val_H", "H"), ("val_I", "I")):
            fig = plt.figure()
            plt.plot(iters, history[metric])
            plt.xlabel("iteration")
            plt.ylabel(label)
            plt.title(f"{label} curves")
            plt.savefig(f"{base}_{label}.png")
            plt.close(fig)
    except Exception as exc:  # plotting must never kill training
        get_logger().warning("plotting failed: %s", exc)

"""LightGCN / LightGCNOpti training, and the trainer's checkpoint IO.

Port of the single-device dense branch of ``lgcnhs_tpu/train/trainer.py``
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
  final tables as an npz checkpoint the JAX trainer's loader reads too.

The JAX step is one jitted XLA program; here a step is eager PyTorch, one
Python call per epoch. Propagation route, as JAX's: on CUDA with
``compute.use_pallas`` (read as "use the hand-written kernels"), the
bfloat16 preset and the kernel's guard, the int8 binary incidence trains
through the ``dual_matmul`` kernel (``ops/cuda/propagation``); everywhere
else the plain dense ``ops/propagation`` route runs, as JAX off the TPU.

RNG: torch cannot reproduce ``jax.random``. Each epoch draws from its own
generator seeded from (seed, epoch) (``epoch_seed``), the counterpart of
``fold_in(key, e)``; the val draw at eval epoch e uses (seed, epochs + e).
The stream does not depend on where a run stopped.

Not ported yet, each raising with its ROADMAP pointer: the mesh branch
(queue 1 item 11), COO propagation and the bf16-dense rung (item 8), and
orbax mid-train resume (item 10). ``--scan-chunk`` has no counterpart
without jit.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from lgcnhs_tpu_torch.config import Config
from lgcnhs_tpu_torch.data.graph import (
    EdgeSet,
    InteractionGraph,
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
from lgcnhs_tpu_torch.ops.cuda.propagation import (
    fits_dual,
    lightgcn_propagate_dual,
    lightgcn_propagate_dual_binary,
    pad_for_dual,
)
from lgcnhs_tpu_torch.ops.propagation import lightgcn_propagate
from lgcnhs_tpu_torch.ops.topk import masked_topk
from lgcnhs_tpu_torch.runtime.device import resolve_device
from lgcnhs_tpu_torch.runtime.logging import get_logger, stage_timer

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


def make_optimizer(hp, params: LightGCNParams) -> torch.optim.Adam:
    """``torch.optim.Adam(lr)`` over the two tables, the reference's
    optimizer; the train step sets each update's lr from ``lr_schedule``
    (the reference's ExponentialLR; ``docs/PARITY.md`` section 2.6 pins
    optax Adam to this pair)."""
    return torch.optim.Adam([params.user_emb, params.item_emb], lr=hp.lr)


def epoch_seed(seed: int, epoch: int) -> int:
    """Seed of epoch ``epoch``'s generator: (seed, epoch) packed in 64 bits."""
    return ((seed & 0xFFFFFFFF) << 32) | (epoch & 0xFFFFFFFF)


def epoch_generator(seed: int, epoch: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(epoch_seed(seed, epoch))
    return g


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
    return bpr_loss(
        u_final[users], params.user_emb[users],
        i_final[pos_items], params.item_emb[pos_items],
        i_final[neg_items], params.item_emb[neg_items],
        epsilon,
    )


#: Device-memory budget of a dense (U, I) incidence / f32 eval-array set,
#: the JAX trainer's 4 GB.
DENSIFY_BUDGET_BYTES = 4e9
#: above this f32-incidence size the JAX trainer takes its bf16-dense rung.
HOST_INCIDENCE_BUILD_BYTES = 2e9


def choose_propagation(n_users: int, n_items: int, n_edges: int, compute) -> str:
    """"dense" or "coo", the single-device rule of the JAX trainer: COO when
    the dense incidence (2 bytes an entry under bfloat16, else 4) would
    exceed 4 GB or its density is below ``compute.dense_threshold``."""
    entry_bytes = 2.0 if getattr(compute, "dtype", "") == "bfloat16" else 4.0
    density = n_edges / max(1.0, float(n_users) * n_items)
    if entry_bytes * n_users * n_items > DENSIFY_BUDGET_BYTES or density < compute.dense_threshold:
        return "coo"
    return "dense"


def make_train_step(optimizer, hp, n_items: int, bf16_matmul: bool = False,
                    use_kernel: bool = False, neg_hi: Optional[int] = None):
    """One epoch: sample -> forward -> BPR -> Adam update with the epoch's
    lr. ``neg_hi`` bounds the negative candidates (``n_items`` by default;
    ``hparams.neg_range='reference'`` passes the split-bounded range).
    Returns ``train_step(params, epoch, generator, R_hat, edge_users,
    edge_items, pos_mask) -> loss`` (detached, before the update)."""
    hi = neg_hi if neg_hi is not None else n_items
    schedule = lr_schedule(hp.lr, hp.gamma, hp.epoch_per_lr_decay)

    def train_step(params, epoch, generator, R_hat, edge_users, edge_items, pos_mask):
        users, pos_items, neg_items = sample_bpr_batch(
            generator, edge_users, edge_items, pos_mask, hp.batch_size, hi
        )
        optimizer.zero_grad(set_to_none=True)
        loss = _loss_fn(params, R_hat, users, pos_items, neg_items, hp.epsilon,
                        hp.layers, bf16_matmul, use_kernel)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = schedule(epoch)
        optimizer.step()
        return loss.detach()

    return train_step


@torch.no_grad()
def val_loss_fn(params, R_hat_val, users, pos_items, neg_items, epsilon, n_layers):
    """Reference ``calValLoss``: forward on the VAL adjacency at the tables'
    precision (never the kernel route), BPR over all val edges
    (``model/LightGCN/evaluation.py:56-86``)."""
    return _loss_fn(params, R_hat_val, users, pos_items, neg_items, epsilon, n_layers)


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
    di^-1/2 f32), the inverse square roots taken in f64. The kernel route
    then pads R's rows (``pad_for_dual``)."""
    R8 = torch.zeros((n_users, n_items), dtype=torch.int8, device=device)
    R8[torch.from_numpy(np.asarray(es.users, np.int64)).to(device),
       torch.from_numpy(np.asarray(es.items, np.int64)).to(device)] = 1

    def inv_sqrt(deg):
        return torch.where(deg > 0, 1.0 / torch.sqrt(deg.clamp_min(1.0)),
                           torch.zeros_like(deg)).float()

    return (R8, inv_sqrt(R8.sum(dim=1, dtype=torch.float64)),
            inv_sqrt(R8.sum(dim=0, dtype=torch.float64)))


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to lgcnhs_tpu_torch yet (ROADMAP queue 1 item {item})"
    )


def train_lightgcn(
    graph: InteractionGraph,
    cfg: Config,
    user_features: Optional[np.ndarray] = None,
    item_features: Optional[np.ndarray] = None,
    save_artifacts: bool = True,
    checkpoint_dir: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> TrainResult:
    """Train LightGCN (or LightGCNOpti when features are given) on
    ``device``: the card unless ``device="cpu"`` is asked for (raises
    without CUDA). Returns the final tables (detached, on ``device``) and
    the per-eval metric history (``train.py:107-177``)."""
    hp = cfg.hparams
    log = get_logger()
    device = resolve_device(device)
    U, I = graph.n_users, graph.n_items
    if checkpoint_dir:
        raise _not_ported("mid-train resume (checkpoint_dir)", 10)
    if tuple(cfg.compute.mesh_shape) != (1, 1):
        raise _not_ported("multi-device training (compute.mesh_shape)", 11)
    if cfg.compute.coo_table_sharding:
        raise ValueError(
            "compute.coo_table_sharding requires a resolved mesh (--mesh); "
            "without one, tables are single-device anyway"
        )
    if cfg.compute.dtype not in _TABLE_DTYPES:
        raise ValueError(f"unknown compute.dtype {cfg.compute.dtype!r}")
    dtype = _TABLE_DTYPES[cfg.compute.dtype]
    np_dtype = np.float64 if dtype == torch.float64 else np.float32

    init_gen = torch.Generator().manual_seed(hp.seed)
    if user_features is not None and item_features is not None:
        params = init_lightgcn_opti(init_gen, user_features, item_features,
                                    hp.embedding_dim, device, dtype)
        model_name = "LightGCNOpti"
    else:
        params = init_lightgcn(init_gen, U, I, hp.embedding_dim, device, dtype)
        model_name = "LightGCN"
    params = LightGCNParams(*(t.detach().clone().to(device, dtype).requires_grad_(True)
                              for t in params))

    _bf16 = cfg.compute.dtype == "bfloat16"
    _kernel = cfg.compute.use_pallas and device.type == "cuda"
    if choose_propagation(U, I, graph.train.n_edges, cfg.compute) == "coo":
        raise _not_ported("COO (large-graph) propagation", 8)

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
    train_deg = dense(item_degrees(I, graph.train))

    # negative-candidate upper bound per split (docs/PARITY.md deviation 6)
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

        neg_hi_train = _split_neg_hi(graph.train, "train")
        neg_hi_val = _split_neg_hi(graph.val, "val")
    elif hp.neg_range == "catalog":
        neg_hi_train = neg_hi_val = I
    else:
        raise ValueError(
            f"unknown hparams.neg_range {hp.neg_range!r} (expected 'catalog' or 'reference')"
        )
    val_reject_uid = hp.neg_range == "reference"

    if _kernel and _bf16 and fits_dual(hp.embedding_dim, device):
        R8, du_inv, di_inv = device_binary_factors(U, I, graph.train, device)
        # the kernel reads R's rows in 16-byte copies; the incidence is
        # constant, so its padded-stride copy is built once for the run
        R_hat = (pad_for_dual(R8), du_inv, di_inv)
        log.info("training %s: int8 binary incidence through the dual_matmul CUDA kernel",
                 model_name)
    elif _bf16 and 4.0 * U * I > HOST_INCIDENCE_BUILD_BYTES:
        raise _not_ported("the bf16-dense training rung", 8)
    else:
        R_hat = dense(normalized_bipartite(U, I, graph.train, dtype=np_dtype),
                      torch.bfloat16 if _bf16 else dtype)
        log.info("training %s: plain dense propagation (%s incidence) on %s",
                 model_name, "bf16" if _bf16 else cfg.compute.dtype, device)
    if 4.0 * U * I > DENSIFY_BUDGET_BYTES:
        raise _not_ported("CSR evaluation of large catalogs", 8)
    R_hat_val = dense(normalized_bipartite(U, I, graph.val, dtype=np_dtype), dtype)
    train_pos = dense(pos_bool_matrix(U, I, graph.train))
    val_pos = dense(pos_bool_matrix(U, I, graph.val))
    train_interaction = dense(interaction_matrix(U, I, graph.train))

    optimizer = make_optimizer(hp, params)
    train_step = make_train_step(optimizer, hp, I, bf16_matmul=_bf16, use_kernel=_kernel,
                                 neg_hi=neg_hi_train)

    history: Dict[str, List[float]] = {name: [] for name in HISTORY_COLUMNS}
    with stage_timer(f"{model_name} training done ({hp.epochs} epochs)", log):
        for epoch in range(hp.epochs):
            loss = train_step(params, epoch, epoch_generator(hp.seed, epoch, device),
                              R_hat, edge_users, edge_items, train_pos)
            if epoch % hp.epoch_per_eval != 0:
                continue
            v_users, v_pos, v_neg = sample_negatives_for_edges(
                epoch_generator(hp.seed, hp.epochs + epoch, device), val_edge_users,
                val_edge_items, val_pos, neg_hi_val, reject_user_ids=val_reject_uid,
            )
            vloss = val_loss_fn(params, R_hat_val, v_users, v_pos, v_neg, hp.epsilon,
                                hp.layers)
            _, p, r, n, h, i = _val_eval(params, train_pos, val_pos, val_counts,
                                         val_present, train_interaction, train_deg,
                                         cfg.k, I)
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
                epoch, hp.epochs, tl, vl, cfg.k, p, cfg.k, r, cfg.k, f1, cfg.k, n,
                cfg.k, h, cfg.k, i,
            )

    params = LightGCNParams(params.user_emb.detach(), params.item_emb.detach())
    if save_artifacts:
        cfg.ensure_dirs()
        save_checkpoint(os.path.join(cfg.model_path, f"{cfg.k}_{model_name}.npz"), params)
        _save_history(cfg, model_name, history)
    return TrainResult(params=params, history=history)


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


def _csv_cell(v) -> str:
    """One value as pandas' ``to_csv`` writes it: ints plainly, floats by
    their shortest repr, NaN as an empty field."""
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return str(int(v))
    v = float(v)
    return "" if math.isnan(v) else repr(v)


def history_csv(history: Dict[str, List[float]]) -> str:
    """The history table as ``pd.DataFrame(history).to_csv(index=False)``
    writes it (the reference's ``train.py:190-196``), without pandas."""
    names = list(history)
    lines = [",".join(names)]
    for row in zip(*(history[n] for n in names)):
        lines.append(",".join(_csv_cell(v) for v in row))
    return "\n".join(lines) + "\n"


def _save_history(cfg: Config, model_name: str, history: Dict[str, List[float]]) -> None:
    """CSV, and the metric curve PNGs where matplotlib imports
    (``train.py:190-221``)."""
    base = os.path.join(cfg.pictures_path, f"{model_name}_{cfg.k}")
    with open(base + "_val_metrics.csv", "w", newline="") as f:
        f.write(history_csv(history))
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

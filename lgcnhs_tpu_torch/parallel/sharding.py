"""Multi-device sharding on the (data, model) mesh.

Port of ``lgcnhs_tpu/parallel/sharding.py`` to ``torch.distributed``
(the reference trains on one hard-wired device, ``model/LightGCN/train.py:87``).
JAX states placements (``NamedSharding``) and lets GSPMD insert the
collectives; here every rank holds only its block of each sharded operand
and the collectives are written out:

- embedding tables (and Adam's moments, which follow them) ROW-sharded over
  "model", zero-padded to divide it (``padded_catalog``);
- the bipartite incidence, the positives and every (U, I) score or mask
  COLUMN-sharded on items, so u' = R . e_i is a sum of shard-local partials
  (``all_reduce`` over "model") and e_i' = R^T . e_u is shard-local once
  e_u is whole (``all_gather_into_tensor`` of its row blocks);
- the minibatch split over "data" (a contiguous slice a rank), the loss and
  the gradients summed over "data";
- full-catalog ranking as a DISTRIBUTED TOP-K: a local top-k on each item
  block, local ids offset to global, the candidates gathered over "model"
  in shard order, one merge under the single-device tie rule;
- the item-item diffusion with no (I, I) operand on one rank: each rank
  owns an output-item block and the other ranks' interaction blocks pass
  through it one at a time (``_ring``).

The large-graph (COO) half: a graph that refuses to densify shards its
EDGE LIST over every rank (``EDGE_AXES``, the world group). Each rank keeps
its edge block (sorted by user and by item for the "segment" layout,
``shard_coo_edges``; degree-bucketed for the "bucketed" one,
``shard_bucketed_incidence``), computes its partial messages a layer and the
world group sums them (``_self_adjoint_sharded_pair``: the backward is the
same pair and sum on the output gradients). The tables and Adam's state
are whole on every rank (``make_sharded_coo_train_step``), or row-sharded
over "model" with the layer-0 tables gathered for the propagation and the
BPR rows exchanged (``make_table_sharded_coo_train_step``). The CSR
evaluation splits users over every rank, each ranking its block through
``ops/scalable.chunked_masked_topk`` (``make_distributed_csr_masked_topk``).

Every public function keeps the JAX signature and meaning: global numpy or
torch arrays go in, and every rank gets the global result back. The
``_*_blocks`` / ``_core`` functions take blocks; the trainer, the sweeps and
the fused recommendation call them on blocks they already hold.

Gradients through the collectives: every rank of a model group computes
the same loss from the joined tensors, so the backward of the sum of
partials passes the gradient through unchanged (``_SumOverModel``;
autograd through ``torch.distributed.nn``'s all_reduce would sum it again,
M times too large) and the backward of a gather takes the rank's own rows
(``_GatherRows``). A whole tensor that goes into a rank-local product
(e_u into R_blk^T . e_u) gets only that block's part of its gradient on
each rank, so its backward sums over the group (``_EnterModel``).

Kernels: a rank's propagation pair (R_blk . e_i_blk, R_blk^T . e_u) is the
``dual_matmul`` contract, so the prod preset on CUDA runs the kernel on
each rank's int8 item block (6 launches a step, as on one device); ranking
by ``distributed_retrieve_topk`` runs the retrieval kernel on each rank's
REAL items (one launch a rank a call); the mesh's CSR evaluation runs it
on each user chunk of the rank's block. JAX caches its staged masked top-k
per (mesh, k, block) (``sharding.py:440``); eager PyTorch has no program
to cache.
"""
from __future__ import annotations

from typing import Callable, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams, bpr_loss, sample_bpr_batch
from lgcnhs_tpu_torch.ops.cuda.propagation import dual_matmul
from lgcnhs_tpu_torch.ops.diffusion import blend_exponents
from lgcnhs_tpu_torch.ops.propagation import (
    BucketedIncidence, EdgeOrdering, build_bucketed_incidence, bucketed_pair, layer_mean,
    self_adjoint, sorted_pair,
)
from lgcnhs_tpu_torch.ops.scalable import chunked_masked_topk, sample_bpr_batch_csr
from lgcnhs_tpu_torch.ops.topk import (
    MASK_VALUE, rank_exclude_seen_topk, retrieval_route, select_topk,
)
from lgcnhs_tpu_torch.runtime.mesh import (
    DATA_AXIS, MODEL_AXIS, Mesh, batch_sharded, col_sharded, replicated, row_sharded,
)

# all_gather_into_tensor; newer torch names it all_gather_single
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


class ShardingPlan(NamedTuple):
    """Where each training operand lives: placement functions
    ``(mesh, global array) -> this rank's block``."""

    mesh: Mesh
    params: LightGCNParams  # placements, not arrays
    r_hat: Callable
    pos_mask: Callable
    edges: Callable
    replicated: Callable


def make_plan(mesh: Mesh) -> ShardingPlan:
    return ShardingPlan(
        mesh=mesh,
        params=LightGCNParams(user_emb=row_sharded, item_emb=row_sharded),
        # R_hat (U, I): items on the model axis, so R_hat^T . e_u and the
        # item table's row blocks line up
        r_hat=col_sharded,
        pos_mask=col_sharded,
        edges=batch_sharded,
        replicated=replicated,
    )


def _pad_len(n: int, parts: int) -> int:
    return -(-n // parts) * parts


def padded_catalog(plan: ShardingPlan, n_users: int, n_items: int) -> Tuple[int, int]:
    """Smallest (U, I) >= the true catalog that divides the model axis.
    The padding is inert: zero incidence rows and columns add exact zeros to
    the propagation, padded positives are True so sampling and top-k never
    reach them, and zero table rows get zero gradients (Adam leaves them
    and their moments at zero)."""
    n_model = plan.mesh.shape[MODEL_AXIS]
    return _pad_len(n_users, n_model), _pad_len(n_items, n_model)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _pad2(x, rows: int, cols: int, value=0):
    x = _np(x)
    if x.shape == (rows, cols):
        return x
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])), constant_values=value)


def _pad1(x, n: int):
    x = _np(x)
    return x if x.shape[0] == n else np.pad(x, (0, n - x.shape[0]))


def shard_train_inputs(plan: ShardingPlan, R_hat, pos_mask, edge_users, edge_items,
                       r_dtype: Optional[torch.dtype] = None):
    """(R block, positives block, edge users, edge items) on this rank: the
    catalog axes padded to the model axis (``padded_catalog``), R_hat and
    the positives cut to the rank's item columns, the edges REPLICATED at
    their true length (padding them would change the sampling modulus and
    the single-device triple stream; every rank draws the whole batch and
    keeps its slice). ``r_dtype`` casts R_hat after padding.

    ``R_hat`` may also be the factored binary incidence
    ``(R int8, du^-1/2, di^-1/2)`` of ``data/graph.binary_incidence_factors``
    (the ``dual_matmul`` route): its block is (R's item columns, du padded,
    di's item block)."""
    mesh = plan.mesh
    U, I = _np(pos_mask).shape
    U_pad, I_pad = padded_catalog(plan, U, I)
    if isinstance(R_hat, tuple):
        R8, du_inv, di_inv = R_hat
        r_blk = (plan.r_hat(mesh, torch.from_numpy(_pad2(R8, U_pad, I_pad))),
                 plan.replicated(mesh, torch.from_numpy(_pad1(du_inv, U_pad))),
                 row_sharded(mesh, torch.from_numpy(_pad1(di_inv, I_pad))))
    else:
        R = torch.from_numpy(_pad2(R_hat, U_pad, I_pad))
        r_blk = plan.r_hat(mesh, R if r_dtype is None else R.to(r_dtype))
    pos_blk = plan.pos_mask(mesh, torch.from_numpy(_pad2(pos_mask, U_pad, I_pad, True)))

    def edges(a):
        return plan.replicated(mesh, torch.from_numpy(np.asarray(a, np.int64)))

    return r_blk, pos_blk, edges(edge_users), edges(edge_items)


def _pad_rows(table: torch.Tensor, target: int) -> torch.Tensor:
    n = table.shape[0]
    if target == n:
        return table
    return torch.cat([table, table.new_zeros((target - n,) + tuple(table.shape[1:]))])


def shard_params(plan: ShardingPlan, params: LightGCNParams) -> LightGCNParams:
    """This rank's row blocks of the tables, each catalog axis zero-padded
    to the model axis (``padded_catalog``); ``unpad_params`` joins them."""
    U_pad, I_pad = padded_catalog(plan, params.user_emb.shape[0], params.item_emb.shape[0])
    return LightGCNParams(
        user_emb=plan.params.user_emb(plan.mesh, _pad_rows(params.user_emb, U_pad)),
        item_emb=plan.params.item_emb(plan.mesh, _pad_rows(params.item_emb, I_pad)),
    )


def _model(mesh: Mesh):
    """(group, size, this rank's index) of the model axis."""
    return mesh.group(MODEL_AXIS), mesh.shape[MODEL_AXIS], mesh.index(MODEL_AXIS)


def _gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The group's equal row blocks of ``x`` joined in rank order."""
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather(out, x.contiguous(), group=group)
    return out


def _gather_cols(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The group's equal column blocks of a 2-d ``x`` joined in rank order."""
    parts = _gather_rows(x, group, n).view(n, *x.shape)
    return parts.permute(1, 0, 2).reshape(x.shape[0], n * x.shape[1])


def unpad_params(params: LightGCNParams, n_users: int, n_items: int,
                 mesh: Optional[Mesh] = None) -> LightGCNParams:
    """The true-shape tables: with ``mesh``, the rank's row blocks are first
    joined over the model axis (every rank gets the whole tables); then the
    padding ``shard_params`` added is cut off. Detached, on the blocks'
    device."""
    tables = [t.detach() for t in params]
    if mesh is not None:
        group, n, _ = _model(mesh)
        tables = [_gather_rows(t, group, n) for t in tables]
    return LightGCNParams(tables[0][:n_users], tables[1][:n_items])


class _SumOverModel(torch.autograd.Function):
    """Forward: the sum of the model group's partials (``all_reduce``).
    Backward: the gradient unchanged, since every rank of the group derives
    the same loss from the sum."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterModel(torch.autograd.Function):
    """A whole tensor going into a rank-local product (R_blk^T . e_u).
    Forward: itself. Backward: the model group's sum of the gradients,
    since each rank's product carries only its block's part of it."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _GatherRows(torch.autograd.Function):
    """Forward: the model group's row blocks joined in rank order.
    Backward: this rank's rows of the gradient."""

    @staticmethod
    def forward(ctx, x, group, n: int, i: int):
        ctx.rows, ctx.i = x.shape[0], i
        return _gather_rows(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.i * ctx.rows:(ctx.i + 1) * ctx.rows], None, None, None


class ShardedColumns:
    """An item-sharded (rows, I) matrix read at global (row, column) pairs:
    ``m[rows, cols]``, as ``models.lightgcn.sample_bpr_batch`` reads its
    ``pos_mask``. Each rank reads the pairs in its column block (zero
    elsewhere) and the model axis sums them, so every rank gets each entry
    exactly (x + 0 + ... = x); bool blocks give bool."""

    def __init__(self, mesh: Mesh, block: torch.Tensor):
        self.block = block
        self.group, _, i = _model(mesh)
        self.start = i * block.shape[1]

    def __getitem__(self, index):
        rows, cols = torch.broadcast_tensors(*index)
        width = self.block.shape[1]
        local = cols.long() - self.start
        mine = (local >= 0) & (local < width)
        vals = self.block[rows.long(), local.clamp(0, width - 1)]
        if self.block.dtype == torch.bool:
            out = (vals & mine).to(torch.int32)
            dist.all_reduce(out, group=self.group)
            return out > 0
        out = torch.where(mine, vals, torch.zeros_like(vals))
        dist.all_reduce(out, group=self.group)
        return out


def _data(mesh: Mesh):
    return mesh.group(DATA_AXIS), mesh.shape[DATA_AXIS]


def _propagation_pair(R_blk, bf16_matmul: bool):
    """The rank's pair (x_u, x_i) -> (R_blk . x_i, R_blk^T . x_u) at the
    single-device routes' precision: the factored int8 block
    ``(R8, du^-1/2, di^-1/2)`` through ``dual_matmul`` as
    ``lightgcn_propagate_dual_binary`` runs it (the kernel on CUDA, its twin
    on the CPU), a dense block through ``torch.matmul`` as
    ``ops/propagation.lightgcn_propagate`` runs it."""
    if isinstance(R_blk, tuple):
        R8, du_inv, di_inv = R_blk
        cdt = torch.bfloat16 if bf16_matmul else torch.float32
        du, di = du_inv[:, None].float(), di_inv[:, None].float()

        def pair(x_u, x_i):
            ou, oi = dual_matmul(R8, (di * x_i).to(cdt), (du * x_u).to(cdt))
            return du * ou, di * oi

        return pair
    if bf16_matmul:
        Rl = R_blk.to(torch.bfloat16).float()

        def pair(x_u, x_i):
            return Rl @ x_i.to(torch.bfloat16).float(), Rl.T @ x_u.to(torch.bfloat16).float()

        return pair

    def pair(x_u, x_i):
        return R_blk @ x_i, R_blk.T @ x_u

    return pair


def sharded_propagate(mesh: Mesh, user_blk, item_blk, R_blk, n_layers: int = 3,
                      bf16_matmul: bool = False):
    """(e_u^final (U_pad, D) whole on every rank, e_i^final's row block,
    e_u^0 whole): the layer mean of K propagation steps with the item axis
    sharded. Each step's user side is the model group's sum of partials."""
    group, n, i = _model(mesh)
    eu = _GatherRows.apply(user_blk, group, n, i)
    eu0, ei = eu, item_blk
    pair = _propagation_pair(R_blk, bf16_matmul)
    acc_u, acc_i = eu, ei
    for _ in range(n_layers):
        part_u, ei = pair(_EnterModel.apply(eu, group), ei)
        eu = _SumOverModel.apply(part_u, group)
        acc_u = acc_u + eu
        acc_i = acc_i + ei
    scale = 1.0 / (n_layers + 1)
    return acc_u * scale, acc_i * scale, eu0


def _sharded_bpr(mesh: Mesh, params: LightGCNParams, R_blk, users, pos_items, neg_items,
                 epsilon: float, n_layers: int, bf16_matmul: bool = False,
                 batch_size: Optional[int] = None):
    """BPR of the triples over the sharded forward. ``batch_size`` set: the
    triples are this rank's slice of a batch of that size, and the value is
    its share (-sum(softplus) / batch_size + the slice's regularizer), which
    the data axis sums to the whole batch's loss."""
    group, n, i = _model(mesh)
    u_final, i_final_blk, eu0 = sharded_propagate(mesh, params.user_emb, params.item_emb,
                                                  R_blk, n_layers, bf16_matmul)
    D = params.item_emb.shape[1]
    joined = _GatherRows.apply(torch.cat([i_final_blk, params.item_emb], dim=1), group, n, i)
    i_final, ei0 = joined[:, :D], joined[:, D:]
    return bpr_loss(u_final[users], eu0[users], i_final[pos_items], ei0[pos_items],
                    i_final[neg_items], ei0[neg_items], epsilon, batch_size)


def make_sharded_train_step(plan: ShardingPlan, optimizer, hp, n_items: int,
                            bf16_matmul: bool = False, neg_hi: Optional[int] = None):
    """The single-device step (``train/trainer._make_step``: the same
    sampler, BPR, Adam and lr schedule) on sharded operands:
    ``step(params, epoch, generator, R_blk, edge_users, edge_items, pos_blk)
    -> loss`` (the whole batch's, detached, before the update). Every rank
    draws the whole batch from ``generator`` (negatives rejected against the
    item-sharded positives, ``ShardedColumns``) and keeps its data slice;
    the gradients of the rank's table blocks are summed over "data" before
    Adam. The form of ``R_blk`` picks the propagation: the factored int8
    block runs ``dual_matmul`` (``_propagation_pair``)."""
    from lgcnhs_tpu_torch.train.trainer import lr_schedule

    mesh = plan.mesh
    hi = neg_hi if neg_hi is not None else n_items
    schedule = lr_schedule(hp.lr, hp.gamma, hp.epoch_per_lr_decay)
    data_group, n_data = _data(mesh)

    def step(params, epoch, generator, R_blk, edge_users, edge_items, pos_blk):
        users, pos_items, neg_items = sample_bpr_batch(
            generator, edge_users, edge_items, ShardedColumns(mesh, pos_blk), hp.batch_size, hi)
        optimizer.zero_grad(set_to_none=True)
        if n_data == 1:
            loss = _sharded_bpr(mesh, params, R_blk, users, pos_items, neg_items, hp.epsilon,
                                hp.layers, bf16_matmul)
        else:
            mine = [batch_sharded(mesh, t) for t in (users, pos_items, neg_items)]
            loss = _sharded_bpr(mesh, params, R_blk, *mine, hp.epsilon, hp.layers,
                                bf16_matmul, batch_size=hp.batch_size)
        loss.backward()
        loss = loss.detach()
        if n_data > 1:
            for table in params:
                dist.all_reduce(table.grad, group=data_group)
            loss = loss.clone()
            dist.all_reduce(loss, group=data_group)
        for group in optimizer.param_groups:
            group["lr"] = schedule(epoch)
        optimizer.step()
        return loss

    return step


def _scan(plan: ShardingPlan, step_once):
    """The counterpart of a JAX ``lax.scan`` over a sharded step: the step
    over ``n_steps`` epochs, each on its own ``epoch_generator(seed, epoch,
    device)`` as the trainer draws. ``train_scan(params, seed, epoch0,
    n_steps, *step_args) -> the last step's loss``."""
    from lgcnhs_tpu_torch.train.trainer import epoch_generator

    def train_scan(params, seed, epoch0, n_steps, *args):
        loss = None
        for epoch in range(epoch0, epoch0 + n_steps):
            loss = step_once(params, epoch, epoch_generator(seed, epoch, plan.mesh.device), *args)
        return loss

    return train_scan


def make_sharded_train_scan(plan: ShardingPlan, optimizer, hp, n_items: int,
                            bf16_matmul: bool = False, neg_hi: Optional[int] = None):
    """The counterpart of JAX's ``make_sharded_train_scan`` (a ``lax.scan``
    over the sharded step between eval boundaries): without jit, the loop of
    the sharded step over ``n_steps`` epochs, each drawing from its own
    ``epoch_generator(seed, epoch, device)`` as the single-device trainer
    does. ``train_scan(params, seed, epoch0, n_steps, R_blk, edge_users,
    edge_items, pos_blk) -> the last step's loss``. The mesh trainer runs
    the step one epoch at a time in the trainer's chunk loop
    (``train/trainer._train_epochs``): a sharded scan as a CUDA graph would
    hold NCCL calls inside the graph."""
    return _scan(plan, make_sharded_train_step(plan, optimizer, hp, n_items, bf16_matmul, neg_hi))


def _internal_similarity_blocks(mesh: Mesh, rec, inter_blk, deg_blk) -> torch.Tensor:
    """``metrics_ops.internal_similarity`` with the (U_i, I) interaction and
    the degrees item-sharded: sum_u ||c_u||^2 minus the diagonal, c_u the
    list's one-hot times the degree-normalized interaction columns, each
    rank's partial of c summed over the model axis."""
    U, k = rec.shape
    block = inter_blk.shape[1]
    start = mesh.index(MODEL_AXIS) * block
    deg = deg_blk.to(torch.float32)
    inv = torch.where(deg > 0, torch.rsqrt(deg), torch.zeros_like(deg))
    A = inter_blk.to(torch.float32)
    local = rec.long() - start
    mine = (local >= 0) & (local < block)
    B = torch.zeros((U, block), dtype=torch.float32, device=rec.device)
    rows = torch.arange(U, device=rec.device)[:, None].expand_as(local)
    B[rows[mine], local[mine]] = 1.0
    c = B @ (A * inv[None, :]).T
    dist.all_reduce(c, group=mesh.group(MODEL_AXIS))
    diag = ShardedColumns(mesh, ((A * A).sum(dim=0) * inv * inv)[None, :].expand(U, -1))
    diag_term = torch.sum(diag[rows, rec.long()])
    return (torch.sum(c * c) - diag_term) / (float(U) * k * (k - 1))



# -- distributed ranking ----------------------------------------------------------------


def _block_width(mesh: Mesh, n_items: int, k: int) -> int:
    n_shards = mesh.shape[MODEL_AXIS]
    block = _pad_len(n_items, n_shards) // n_shards
    if k > block:
        raise ValueError(f"k={k} exceeds shard width {block}")
    return block


def _merge_topk(mesh: Mesh, vals: torch.Tensor, idx: torch.Tensor, k: int) -> torch.Tensor:
    """One top-k over the model group's (U, k) candidates joined in shard
    order: ties go to the lower shard, and within a shard to the lower id,
    so the merge keeps the lowest-global-index rule."""
    group, n, _ = _model(mesh)
    all_vals, all_idx = _gather_cols(vals, group, n), _gather_cols(idx, group, n)
    sel = select_topk(all_vals, k)[1].long()
    return torch.gather(all_idx, 1, sel).to(torch.int32)


def _masked_topk_blocks(mesh: Mesh, scores_blk, seen_blk, k: int, block: int) -> torch.Tensor:
    """``distributed_masked_topk`` on blocks the caller holds: the rank's
    (U, block) scores and seen mask."""
    masked = torch.where(seen_blk, torch.full_like(scores_blk, MASK_VALUE), scores_blk)
    vals, idx = select_topk(masked, k)
    return _merge_topk(mesh, vals, idx + mesh.index(MODEL_AXIS) * block, k)


def distributed_masked_topk(mesh: Mesh, scores, seen, k: int) -> torch.Tensor:
    """Two-phase distributed top-k: each item shard takes a LOCAL top-k of
    its masked scores (k <= shard width), offsets local ids to global, and
    one merge over the gathered n_shards * k candidates keeps the lowest
    global index among ties. Masking before the local top-k keeps the
    seen-item exclusion exact. Padded columns score -inf unmasked: below
    every real column, never selected. (U, k) int32 on every rank."""
    scores, seen = torch.as_tensor(scores), torch.as_tensor(seen)
    U, I = scores.shape
    block = _block_width(mesh, I, k)
    I_pad = block * mesh.shape[MODEL_AXIS]
    pad = (0, I_pad - I)
    scores_blk = col_sharded(mesh, torch.nn.functional.pad(scores, pad, value=-torch.inf))
    seen_blk = col_sharded(mesh, torch.nn.functional.pad(seen, pad, value=False))
    return _masked_topk_blocks(mesh, scores_blk, seen_blk, k, block)


def _local_retrieval(ue, ie_blk, seen_blk, k: int):
    """(ids, values) of the masked layer-0 top-k of one item block, along
    ``ops/topk.retrieval_route``: the retrieval kernel on CUDA for f32
    tables, else the plain chain."""
    if retrieval_route(ue.device.type, ue.dtype) == "kernel":
        from lgcnhs_tpu_torch.ops.cuda.retrieval import fused_topk_retrieval

        return fused_topk_retrieval(ue, ie_blk, seen_blk, k)
    scores = ue @ ie_blk.T
    vals, idx = select_topk(torch.where(seen_blk, torch.full_like(scores, MASK_VALUE), scores), k)
    return idx, vals


def distributed_retrieve_topk(mesh: Mesh, user_emb, item_emb, seen, k: int) -> torch.Tensor:
    """Sharded full-catalog retrieval: each rank scores its item block
    against all users (the retrieval kernel on CUDA, one launch), takes a
    local top-k, offsets to global ids, and one merge top-k combines the
    gathered candidates. (U, k) int32 on every rank.

    JAX pads the item axis and marks padded columns -inf (mask state 2).
    The port's kernel takes a bool mask and needs k <= its catalog, and a
    zero-padded item would score 0 and beat real items, so each rank passes
    only its REAL items; a rank with fewer than k of them fills the missing
    slots with -inf (never merged ahead of a real candidate, since the
    catalog holds at least k items)."""
    dev = mesh.device
    item_emb, seen = torch.as_tensor(item_emb), torch.as_tensor(seen)
    U, I = seen.shape
    block = _block_width(mesh, I, k)
    start = mesh.index(MODEL_AXIS) * block
    real = max(0, min(block, I - start))
    ue = replicated(mesh, user_emb)
    vals = torch.full((U, k), -torch.inf, dtype=ue.dtype, device=dev)
    idx = torch.zeros((U, k), dtype=torch.int32, device=dev)
    if real:
        kk = min(k, real)
        ie_blk = item_emb[start:start + real].to(dev)
        seen_blk = seen[:, start:start + real].to(dev)
        local_idx, local_vals = _local_retrieval(ue, ie_blk, seen_blk, kk)
        vals[:, :kk] = local_vals.to(ue.dtype)
        idx[:, :kk] = local_idx + start
    return _merge_topk(mesh, vals, idx, k)


def _lexsort_merge(vals, idx, sel_seen, k: int, filter_seen: bool) -> torch.Tensor:
    """The first k ids of each row under the total order (seen ASC, score
    DESC, index DESC), by stable sorts from the last key to the first. +0.0
    and -0.0 tie, as ``jnp.lexsort`` compares them."""
    vals = torch.where(vals == 0, torch.zeros_like(vals), vals)
    perm = torch.sort(idx, dim=1, descending=True, stable=True)[1]
    by_val = torch.sort(torch.gather(vals, 1, perm), dim=1, descending=True, stable=True)[1]
    perm = torch.gather(perm, 1, by_val)
    if filter_seen:
        seen_in_order = torch.gather(sel_seen.to(torch.int32), 1, perm)
        perm = torch.gather(perm, 1, torch.sort(seen_in_order, dim=1, stable=True)[1])
    return torch.gather(idx, 1, perm[:, :k]).to(torch.int32)


def _distributed_rank_core(mesh: Mesh, scores_blk, seen_blk, k: int, filter_seen: bool,
                           block: int) -> torch.Tensor:
    """``distributed_rank_exclude_seen`` on blocks the caller holds (the
    item axis padded to divide the model axis, padded columns seen with
    -inf scores). Reused by the item-sharded lambda sweep and the fused
    recommendation."""
    group, n, i = _model(mesh)
    order = rank_exclude_seen_topk(scores_blk, seen_blk, k, filter_seen).long()
    vals = torch.gather(scores_blk, 1, order)
    sel_seen = torch.gather(seen_blk, 1, order).to(torch.int32)
    gidx = (order + i * block).to(torch.int64)
    return _lexsort_merge(_gather_cols(vals, group, n), _gather_cols(gidx, group, n),
                          _gather_cols(sel_seen, group, n), k, filter_seen)


def distributed_rank_exclude_seen(mesh: Mesh, scores, seen, k: int,
                                  filter_seen: bool = True) -> torch.Tensor:
    """Distributed ``ops.topk.rank_exclude_seen`` (the spread and fusion
    ranker). Its order is the total order (seen ASC, score DESC, index
    DESC), and a global top-k under a total order is the merge of the
    shards' top-k's under it: each item shard ranks its block with the
    single-device ranker, the n_shards * k candidates are gathered, one
    lexicographic sort picks the final k. Padded columns enter seen with
    -inf scores, last among the seen; with ``filter_seen=False`` (the
    ProbS-on-movielens quirk) the seen key drops and -inf still ranks
    last. (U, k) int32 on every rank."""
    scores, seen = torch.as_tensor(scores), torch.as_tensor(seen)
    U, I = scores.shape
    block = _block_width(mesh, I, k)
    pad = (0, block * mesh.shape[MODEL_AXIS] - I)
    scores_blk = col_sharded(mesh, torch.nn.functional.pad(scores, pad, value=-torch.inf))
    seen_blk = col_sharded(mesh, torch.nn.functional.pad(seen, pad, value=True))
    return _distributed_rank_core(mesh, scores_blk, seen_blk, k, filter_seen, block)


# -- item-sharded diffusion --------------------------------------------------------------


def _ring(mesh: Mesh, blk: torch.Tensor) -> Iterator[Tuple[int, torch.Tensor]]:
    """(m, block of model rank m) for every m in order: this rank's own
    block at its turn, a broadcast from rank m otherwise. One other rank's
    block is alive at a time, so no rank ever holds the whole array."""
    group, n, i = _model(mesh)
    blk = blk.contiguous()
    for m in range(n):
        buf = blk if m == i else torch.empty_like(blk)
        dist.broadcast(buf, src=mesh.peer(MODEL_AXIS, m), group=group)
        yield m, buf


def _user_degrees(mesh: Mesh, A_blk: torch.Tensor) -> torch.Tensor:
    """k_user of the whole A (the model group's row sums), zeros clamped to
    1 (``ops/diffusion.general_spreading_matrix``)."""
    k_user = A_blk.sum(dim=1)
    dist.all_reduce(k_user, group=mesh.group(MODEL_AXIS))
    return torch.where(k_user == 0, torch.ones_like(k_user), k_user)


def _item_degrees(mesh: Mesh, A_blk: torch.Tensor) -> torch.Tensor:
    """The (I_pad,) item degrees of the whole A, on every rank."""
    group, n, _ = _model(mesh)
    return _gather_rows(A_blk.sum(dim=0), group, n)


def _blend_denominator(k_rows, k_cols, lam, dtype, device) -> torch.Tensor:
    """HybridS's k_i^(1-l) (x) k_j^l with zeros set to 1
    (``ops/diffusion.hybrid_transfer``) for rows ``k_rows`` and columns
    ``k_cols``."""
    one_minus, lam = blend_exponents(lam, dtype, device)
    denom = torch.pow(k_rows, one_minus)[:, None] * torch.pow(k_cols, lam)[None, :]
    return denom.masked_fill_(denom == 0, 1.0)


def _spreading_block(mesh: Mesh, A_blk: torch.Tensor, k_user: torch.Tensor) -> torch.Tensor:
    """The rank's (I_pad, block) column block of W_gen = (A^T / k_user) . A,
    each row block m from model rank m's block of A (a collective Gram)."""
    rows = []
    for _, A_m in _ring(mesh, A_blk):
        rows.append((A_m / k_user[:, None]).T @ A_blk)
    return torch.cat(rows)


def _resource_from_transfer(mesh: Mesh, A_blk: torch.Tensor, W_blk: torch.Tensor) -> torch.Tensor:
    """F's column block A . W[:, block] = sum_m A_m . W[m rows, block]."""
    block = A_blk.shape[1]
    F_blk = None
    for m, A_m in _ring(mesh, A_blk):
        term = A_m @ W_blk[m * block:(m + 1) * block]
        F_blk = term if F_blk is None else F_blk + term
    return F_blk


def _hybrid_resource_block(mesh: Mesh, A_blk: torch.Tensor, lam) -> torch.Tensor:
    """The rank's (U, block) column block of F = A . HybridS(l) with no
    (I, I) operand anywhere: for each model rank m, W's (m, block) tile
    (A_m^T / k_user) . A_blk, blended, then A_m times it."""
    block = A_blk.shape[1]
    i = mesh.index(MODEL_AXIS)
    k_user = _user_degrees(mesh, A_blk)
    k_item = _item_degrees(mesh, A_blk)
    k_cols = k_item[i * block:(i + 1) * block]
    F_blk = None
    for m, A_m in _ring(mesh, A_blk):
        W_tile = (A_m / k_user[:, None]).T @ A_blk
        W_tile = W_tile / _blend_denominator(k_item[m * block:(m + 1) * block], k_cols, lam,
                                             A_blk.dtype, A_blk.device)
        term = A_m @ W_tile
        F_blk = term if F_blk is None else F_blk + term
    return F_blk


def sharded_diffusion_scores(mesh: Mesh, A, lam) -> torch.Tensor:
    """Item-block-sharded two-pass HybridS diffusion F = A . W(l): A's
    columns over the model axis (padded with zero columns, which leave
    every degree and every real entry unchanged), each rank forming its
    column block of F from the other ranks' blocks of A in turn. (U, I) on
    every rank, A's dtype."""
    A = torch.as_tensor(A)
    U, I = A.shape
    n = mesh.shape[MODEL_AXIS]
    I_pad = _pad_len(I, n)
    A_blk = col_sharded(mesh, torch.nn.functional.pad(A, (0, I_pad - I)))
    F_blk = _hybrid_resource_block(mesh, A_blk, lam)
    return _gather_cols(F_blk, mesh.group(MODEL_AXIS), n)[:, :I]


# -- the edge-sharded COO half -----------------------------------------------------------

#: The axes the edge list splits over (JAX's ``EDGE_AXES``): every rank of the
#: mesh, in the flattened (data, model) order. The mesh spans the whole
#: process group (``runtime/mesh.make_mesh``) and ``init_device_mesh`` lays the
#: global ranks out in that order, so these axes' group is the world group and
#: a rank's block index is its global rank.
EDGE_AXES = (DATA_AXIS, MODEL_AXIS)


def _edges(mesh: Mesh) -> Tuple[int, int]:
    """(this rank's block index over ``EDGE_AXES``, the block count)."""
    index = 0
    for axis in EDGE_AXES:
        index = index * mesh.shape[axis] + mesh.index(axis)
    return index, mesh.size


def shard_coo_edges(plan: ShardingPlan, edge_users, edge_items, edge_norm) -> EdgeOrdering:
    """This rank's edge block, sorted by user and by item on the host, on
    the rank's device. The list is padded to divide the mesh (padding edges
    point at user 0 and item 0 with weight 0: exact zero messages) and cut
    into contiguous blocks over ``EDGE_AXES``; the six arrays are the
    rank's slices of JAX's six per-shard-sorted arrays."""
    r, n_dev = _edges(plan.mesh)
    eu, ei, norm = _np(edge_users), _np(edge_items), _np(edge_norm)
    E = eu.shape[0]
    block = _pad_len(E, n_dev) // n_dev
    pad = (0, block * n_dev - E)
    eu, ei, norm = (np.pad(a, pad)[r * block:(r + 1) * block] for a in (eu, ei, norm))
    pu, pi = np.argsort(eu, kind="stable"), np.argsort(ei, kind="stable")

    def put(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(plan.mesh.device)

    return EdgeOrdering(put(eu[pu], np.int64), put(ei[pu], np.int64), put(norm[pu]),
                        put(eu[pi], np.int64), put(ei[pi], np.int64), put(norm[pi]))


def _sum_over_edges(msg_u: torch.Tensor, msg_i: torch.Tensor):
    """The world group's sum of the ranks' partial messages, one all_reduce
    for both sides."""
    both = torch.cat([msg_u, msg_i])
    dist.all_reduce(both)
    return both[:msg_u.shape[0]], both[msg_u.shape[0]:]


def _self_adjoint_sharded_pair(local_pair):
    """JAX's ``_self_adjoint_sharded_pair``: the rank's linear pair over its
    edge block, then the world group's sum, with the self-adjoint backward
    (the same pair and sum on the output gradients). The loss is the same
    on every rank, so every rank's output gradients are the whole ones and
    the backward's sum adds each edge block's share once."""
    return self_adjoint(lambda x_u, x_i: _sum_over_edges(*local_pair(x_u, x_i)))


def _coo_propagate_sharded(n_users: int, n_items: int, n_layers: int):
    """Edge-sharded propagation, the "segment" layout:
    ``propagate(ue, ie, order)`` with ``order`` the rank's sorted block
    (``shard_coo_edges``), each layer the rank's sorted segment sums
    (``ops/propagation.sorted_pair``) summed over the world group."""

    def propagate(ue, ie, order: EdgeOrdering):
        pair = _self_adjoint_sharded_pair(sorted_pair(order, n_users, n_items))
        return layer_mean(pair, ue, ie, n_layers)

    return propagate


def shard_bucketed_incidence(plan: ShardingPlan, edge_users, edge_items, edge_norm,
                             n_users: int, n_items: int, min_cap: int = 4) -> BucketedIncidence:
    """This rank's block of the edge-sharded bucketed-ELL layout: the edge
    list in ``np.array_split`` blocks over ``EDGE_AXES`` (JAX's split), the
    rank's block degree-bucketed by ``ops/propagation.build_bucketed_incidence``
    on the rank's device.

    JAX stacks every device's buckets into ``ShardedBucketedSide`` arrays
    padded to common shapes, because one SPMD program runs them all. A rank
    here runs its own block, so its buckets keep their own shapes and no
    stacked type exists: the layouts differ by rank, the sums are the
    same."""
    r, n_dev = _edges(plan.mesh)
    eu, ei, norm = (np.array_split(_np(a), n_dev)[r] for a in (edge_users, edge_items, edge_norm))
    return build_bucketed_incidence(eu, ei, norm, n_users, n_items, min_cap,
                                    device=plan.mesh.device)


def _bucketed_propagate_sharded(n_layers: int):
    """Edge-sharded propagation, the "bucketed" layout (production):
    ``propagate(ue, ie, binc)`` with ``binc`` the rank's block
    (``shard_bucketed_incidence``), each layer its gathers and dense sums
    summed over the world group."""

    def propagate(ue, ie, binc: BucketedIncidence):
        return layer_mean(_self_adjoint_sharded_pair(bucketed_pair(binc)), ue, ie, n_layers)

    return propagate


def _coo_step(optimizer, hp, n_items: int, neg_hi: Optional[int], propagate, layer0, rows_u,
              rows_i):
    """The single-device COO step (``train/trainer._make_step``: the CSR
    sampler on the replicated edge list, BPR, Adam, the lr schedule) over a
    sharded propagation: ``layer0(params)`` gives the whole layer-0 tables it
    propagates, ``rows_u(user_table, ids)`` and ``rows_i(item_table, ids)``
    the BPR's layer-0 rows."""
    from lgcnhs_tpu_torch.train.trainer import _make_step

    hi = neg_hi if neg_hi is not None else n_items

    def sample(generator, edge_users, edge_items, keys):
        return sample_bpr_batch_csr(generator, edge_users, edge_items, keys, hp.batch_size, hi)

    def loss_of(params, se, users, pos_items, neg_items):
        u_final, i_final = propagate(*layer0(params), se)
        return bpr_loss(u_final[users], rows_u(params.user_emb, users),
                        i_final[pos_items], rows_i(params.item_emb, pos_items),
                        i_final[neg_items], rows_i(params.item_emb, neg_items), hp.epsilon)

    return _make_step(optimizer, hp, sample, loss_of)


def make_sharded_coo_train_step(plan: ShardingPlan, optimizer, hp, n_users: int,
                                n_items: int, neg_hi: Optional[int] = None,
                                layout: str = "bucketed"):
    """Edge-sharded ``train/trainer.make_coo_train_step``:
    ``step(params, epoch, generator, se, edge_users, edge_items, keys) ->
    loss``, with the tables and Adam's state whole on every rank. Every rank
    draws the single-device triples (``sample_bpr_batch_csr`` on the
    replicated edges and their ``csr_keys``) and computes the whole loss and
    update; only the propagation is split, over edge blocks. No gradient
    sum over "data": the batch is not split. ``layout``: "bucketed"
    (production; ``se`` from ``shard_bucketed_incidence``) or "segment"
    (sorted segment sums; ``se`` from ``shard_coo_edges``)."""
    if layout == "bucketed":
        propagate = _bucketed_propagate_sharded(hp.layers)
    elif layout == "segment":
        propagate = _coo_propagate_sharded(n_users, n_items, hp.layers)
    else:
        raise ValueError(f"unknown sharded COO layout {layout!r}")
    def rows(table, ids):
        return table[ids]

    return _coo_step(optimizer, hp, n_items, neg_hi, propagate, lambda params: params, rows, rows)


def _row_gather_by_shard(plan: ShardingPlan, n_pad: int):
    """``gather(table_blk, ids) -> (B, D)`` rows of a table row-sharded over
    "model" (padded to ``n_pad`` rows): each rank gives the rows it owns
    (zeros for the others) and the model group sums them, O(B D) bytes and
    no table gathered. Backward: the sum passes the (replicated) gradient
    through (``_SumOverModel``) and the rank's owned rows take their share."""
    group, n_model, i = _model(plan.mesh)
    block = n_pad // n_model

    def gather(table_blk, ids):
        local = ids - i * block
        mine = (local >= 0) & (local < block)
        rows = torch.where(mine[:, None], table_blk[local.clamp(0, block - 1)], 0.0)
        return _SumOverModel.apply(rows, group)

    return gather


def make_table_sharded_coo_train_step(plan: ShardingPlan, optimizer, hp, n_users: int,
                                      n_items: int, neg_hi: Optional[int] = None):
    """``make_sharded_coo_train_step`` (bucketed layout) with the tables and
    both Adam moments row-sharded over "model", padded by
    ``padded_catalog`` (``shard_params``): about 1/M of the persistent table
    bytes on each rank. The layer-0 tables are gathered over the model group
    for the propagation (``_GatherRows``: backward, the rank's rows of the
    replicated gradient), the BPR's layer-0 rows exchanged through
    ``_row_gather_by_shard``. ``se`` from ``shard_bucketed_incidence`` over
    the padded sizes. Padded rows are zero, get zero gradient and stay zero
    under Adam. The same triples as the replicated plan; the loss equals it
    up to float sum order."""
    group, n, i = _model(plan.mesh)
    U_pad, I_pad = padded_catalog(plan, n_users, n_items)

    def layer0(params):
        return tuple(_GatherRows.apply(t, group, n, i) for t in params)

    return _coo_step(optimizer, hp, n_items, neg_hi, _bucketed_propagate_sharded(hp.layers),
                     layer0, _row_gather_by_shard(plan, U_pad),
                     _row_gather_by_shard(plan, I_pad))


def make_sharded_coo_train_scan(plan: ShardingPlan, optimizer, hp, n_users: int,
                                n_items: int, neg_hi: Optional[int] = None,
                                layout: str = "bucketed"):
    """``make_sharded_coo_train_step`` over ``n_steps`` epochs (``_scan``):
    ``train_scan(params, seed, epoch0, n_steps, se, edge_users, edge_items,
    keys)``."""
    return _scan(plan, make_sharded_coo_train_step(plan, optimizer, hp, n_users, n_items,
                                                   neg_hi, layout))


def make_table_sharded_coo_train_scan(plan: ShardingPlan, optimizer, hp, n_users: int,
                                      n_items: int, neg_hi: Optional[int] = None):
    """``make_table_sharded_coo_train_step`` over ``n_steps`` epochs
    (``_scan``)."""
    return _scan(plan, make_table_sharded_coo_train_step(plan, optimizer, hp, n_users,
                                                         n_items, neg_hi))


# -- the mesh's CSR evaluation ----------------------------------------------------------


def make_distributed_csr_masked_topk(mesh: Mesh, rowptr: np.ndarray, cols: np.ndarray,
                                     n_users: int):
    """The user-sharded ``ops/scalable.chunked_masked_topk``, staged once:
    returns ``run(user_emb, item_emb, k) -> (U, k) int32`` on every rank.

    The users split over every rank in contiguous blocks of
    ceil(U / ranks) (JAX's padded user blocks); a rank's CSR rows are cut
    out and put on its device here, once, since the trainer calls ``run``
    at every evaluation. ``run`` ranks the rank's block against the whole
    item table through ``chunked_masked_topk`` (the retrieval kernel on
    CUDA for f32 tables, one launch a user chunk; a rank whose block is
    empty launches nothing) and the blocks' ids are gathered over the world
    group. The ids are ``masked_topk``'s: cutting the user axis changes no
    user's list."""
    r, n_dev = _edges(mesh)
    blk = _pad_len(n_users, n_dev) // n_dev
    start, stop = min(r * blk, n_users), min((r + 1) * blk, n_users)
    rowptr = np.asarray(rowptr, np.int64)
    local_rowptr = rowptr[start:stop + 1] - rowptr[start]
    local_cols = torch.from_numpy(np.asarray(cols[rowptr[start]:rowptr[stop]],
                                             np.int64)).to(mesh.device)

    def run(user_emb, item_emb, k: int) -> torch.Tensor:
        ue = torch.as_tensor(user_emb).to(mesh.device)
        ie = torch.as_tensor(item_emb).to(mesh.device)
        out = torch.zeros((blk, k), dtype=torch.int32, device=mesh.device)
        if stop > start:
            out[:stop - start] = chunked_masked_topk(ue[start:stop], ie, local_rowptr,
                                                     local_cols, k)
        return _gather_rows(out, None, n_dev)[:n_users]

    return run


def distributed_csr_masked_topk(mesh: Mesh, user_emb, item_emb, rowptr: np.ndarray,
                                cols: np.ndarray, k: int) -> torch.Tensor:
    """One call of ``make_distributed_csr_masked_topk`` (staged and run
    once; a caller that ranks again holds the closure)."""
    run = make_distributed_csr_masked_topk(mesh, rowptr, cols, int(user_emb.shape[0]))
    return run(user_emb, item_emb, k)

"""LightGCNOpti training epochs, in plain PyTorch.

Independent of the program; what it follows is the published model and
the reference repository's trainer (``model/LightGCNOpti/model.py:35-49``,
``model/LightGCN/{model,loss,train}.py``):

- the layer-0 tables from one random projection of the side features,
  ``Linear``'s U(-1/sqrt(fan_in), 1/sqrt(fan_in)) drawn for W then b, users
  first, from a CPU generator seeded with the training seed;
- each epoch one minibatch of ``batch`` BPR triples: ``batch`` train edges
  uniform with replacement, each with a uniform negative, the first of 8
  candidate rounds that is no train positive of the user; the draws come
  from a generator of the device seeded with (seed, epoch) packed in 64
  bits, as the port seeds its epochs;
- the symmetric-normalized propagation over the deduplicated train edges,
  the mean of layers 0..L;
- the sign-flipped BPR of the reference, ``-mean(softplus(pos - neg))``
  plus epsilon times the squared norms of the batch's layer-0 rows;
- Adam (0.9, 0.999, 1e-8), epoch e its (e + 1)-th step, at lr0 *
  gamma^max(0, (e - 1) // decay).

``follow`` runs epochs from a ``State``: the initial one made from the
seed, or the program's own at a boundary of its window (its tables and
Adam's moments, which the reference then steps on by its own rules).
Everything is float32 with TF32 off. ``precision="fp8"`` is the control:
each layer's propagated operand rounded to float8 e4m3 with a per-tensor
scale (the step below the configured bfloat16). The faults:
``half_batch``, the loss over the first half of each batch only;
``lr_decay=False``, every epoch at lr0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from portbench.reference.data import Split, first_unique, pair_keys

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
N_RETRIES = 8


@dataclass
class State:
    """The tables (users, items) and Adam's first and second moments."""

    tables: List[torch.Tensor]
    exp_avg: List[torch.Tensor]
    exp_avg_sq: List[torch.Tensor]

    def to(self, device) -> "State":
        return State(*([t.to(device) for t in group]
                       for group in (self.tables, self.exp_avg, self.exp_avg_sq)))


@dataclass
class Followed:
    losses: List[float]  # each epoch's loss, before its update
    first_grad_norms: List[float]  # per table: the first epoch's gradient
    state: State  # after the last epoch


@dataclass
class TrainGraph:
    """The train edges (deduplicated, first occurrence first), their
    weights and the sorted pair keys the sampler rejects against."""

    n_users: int
    n_items: int
    eu: torch.Tensor
    ei: torch.Tensor
    weight: torch.Tensor
    keys: torch.Tensor


def epoch_seed(seed: int, epoch: int) -> int:
    return ((seed & 0xFFFFFFFF) << 32) | (epoch & 0xFFFFFFFF)


def sym_weights(eu: torch.Tensor, ei: torch.Tensor, n_users: int, n_items: int):
    """1 / sqrt(d_u d_i) an edge, binary degrees, factors taken in float64."""
    du = torch.bincount(eu, minlength=n_users).double()
    di = torch.bincount(ei, minlength=n_items).double()
    inv_u = torch.where(du > 0, du.clamp_min(1).rsqrt(), 0.0)
    inv_i = torch.where(di > 0, di.clamp_min(1).rsqrt(), 0.0)
    return inv_u[eu] * inv_i[ei]


def train_graph(split: Split, device) -> TrainGraph:
    U, I = split.n_users, split.n_items
    tu, ti = first_unique(split.train_users, split.train_items, I)
    eu = torch.from_numpy(tu).to(device)
    ei = torch.from_numpy(ti).to(device)
    return TrainGraph(U, I, eu, ei, sym_weights(eu, ei, U, I).float(),
                      torch.from_numpy(pair_keys(tu, ti, I)).to(device))


def initial_tables(user_features: np.ndarray, item_features: np.ndarray, dim: int,
                   seed: int):
    gen = torch.Generator().manual_seed(seed)
    out = []
    for feats in (user_features, item_features):
        x = torch.tensor(np.asarray(feats, np.float32))
        bound = 1.0 / np.sqrt(x.shape[1])
        W = torch.empty(x.shape[1], dim).uniform_(-bound, bound, generator=gen)
        b = torch.empty(dim).uniform_(-bound, bound, generator=gen)
        out.append(x @ W + b)
    return out


def initial_state(user_features, item_features, dim: int, seed: int, device) -> State:
    tables = [t.to(device) for t in initial_tables(user_features, item_features, dim, seed)]
    return State(tables, [torch.zeros_like(t) for t in tables],
                 [torch.zeros_like(t) for t in tables])


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, gradient passed
    straight through."""
    scale = 448.0 / x.detach().abs().max().clamp_min(1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x).detach()


def propagate(user_emb, item_emb, eu, ei, weight, n_layers: int, precision: str):
    cast = _fp8 if precision == "fp8" else (lambda t: t)
    xu, xi = user_emb, item_emb
    acc_u, acc_i = xu, xi
    w = weight[:, None]
    for _ in range(n_layers):
        qu, qi = cast(xu), cast(xi)
        nu = torch.zeros_like(xu).index_add(0, eu, w * qi[ei])
        ni = torch.zeros_like(xi).index_add(0, ei, w * qu[eu])
        xu, xi = nu, ni
        acc_u, acc_i = acc_u + xu, acc_i + xi
    return acc_u / (n_layers + 1), acc_i / (n_layers + 1)


def bpr(tables, fu, fi, users, pos, neg, epsilon: float) -> torch.Tensor:
    u0, p0, n0 = tables[0][users], tables[1][pos], tables[1][neg]
    reg = epsilon * ((u0 * u0).sum() + (p0 * p0).sum() + (n0 * n0).sum())
    diff = (fu[users] * fi[pos]).sum(-1) - (fu[users] * fi[neg]).sum(-1)
    return -torch.logaddexp(diff, torch.zeros_like(diff)).mean() + reg


def first_clean(cands: torch.Tensor, users: torch.Tensor, keys: torch.Tensor, n_items: int):
    """Per column of ``cands`` (rounds, n), the first round's candidate
    that is no positive of the column's user (round 0 if none is)."""
    probe = users[None, :] * n_items + cands
    at = torch.searchsorted(keys, probe).clamp_max(keys.shape[0] - 1)
    collide = keys[at] == probe
    return cands.gather(0, torch.argmax((~collide).int(), dim=0)[None, :])[0]


def follow(graph: TrainGraph, state: State, cfg: dict, seed: int, epoch0: int, n_steps: int,
           precision: str = "float32", half_batch: bool = False,
           lr_decay: bool = True) -> Followed:
    """Epochs ``epoch0 .. epoch0 + n_steps - 1`` from ``state`` (not changed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = graph.eu.device
    I, L, B = graph.n_items, cfg["layers"], cfg["batch_size"]
    tables = [t.detach().clone().to(device).requires_grad_(True) for t in state.tables]
    m = [t.detach().clone().to(device) for t in state.exp_avg]
    v = [t.detach().clone().to(device) for t in state.exp_avg_sq]
    losses, first_grad = [], []
    b1, b2 = ADAM_BETAS
    for epoch in range(epoch0, epoch0 + n_steps):
        gen = torch.Generator(device=device)
        gen.manual_seed(epoch_seed(seed, epoch))
        idx = torch.randint(0, graph.eu.shape[0], (B,), generator=gen, device=device)
        users, pos = graph.eu[idx], graph.ei[idx]
        cands = torch.randint(0, I, (N_RETRIES, B), generator=gen, device=device)
        neg = first_clean(cands, users, graph.keys, I)
        if half_batch:
            users, pos, neg = users[:B // 2], pos[:B // 2], neg[:B // 2]
        fu, fi = propagate(tables[0], tables[1], graph.eu, graph.ei, graph.weight, L, precision)
        loss = bpr(tables, fu, fi, users, pos, neg, cfg["epsilon"])
        grads = torch.autograd.grad(loss, tables)
        losses.append(loss.detach())
        if epoch == epoch0:
            first_grad = [float(g.norm()) for g in grads]
        decays = max(0, (epoch - 1) // cfg["epoch_per_lr_decay"]) if lr_decay else 0
        lr = cfg["lr"] * cfg["gamma"] ** decays
        t = epoch + 1
        with torch.no_grad():
            for p, g, mi, vi in zip(tables, grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (vi / (1 - b2 ** t)).sqrt_().add_(ADAM_EPS)
                p.sub_(lr * (mi / (1 - b1 ** t)) / denom)
    return Followed([float(x) for x in losses], first_grad,
                    State([t.detach() for t in tables], m, v))


def change_norms(before: List[torch.Tensor], after: List[torch.Tensor]) -> List[float]:
    return [float((a.to(b.device) - b).norm()) for b, a in zip(before, after)]

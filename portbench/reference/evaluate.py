"""The trainer's evaluation row at a boundary, in plain PyTorch.

Independent of the program; what it follows is the reference repository's
evaluation (``model/LightGCN/evaluation.py:31-86``, ``metrics/accurate.py``,
``metrics/diversity.py``), for the tables the program held at the boundary:

- the val loss: the training BPR (``reference/train.py``) of every
  deduplicated val edge once, in order of first occurrence, each with the
  first of 8 uniform candidate negatives that is no val positive of the
  user, drawn from a generator of the device seeded with (seed, epochs +
  epoch); propagated over the val edges under their own binary degrees;
- the top k of the layer-0 scores user . item, train positives masked;
- over the users with a val row: P@k (hits over k), R@k (hits over the
  user's val rows), F1 = 2PR / (P + R), NDCG@k (binary relevance, log2
  discount, the ideal list all k relevant);
- H@k over all users' lists: the mean over ordered pairs of users of
  1 - overlap / k;
- I@k: the mean over each list's ordered pairs of distinct items of
  cooc(i, j) / sqrt(deg_i deg_j), cooc from the 0/1 train interactions,
  deg the items' train rows.

Float64. ``precision="fp8"`` is the control: the tables rounded to float8
e4m3 under a per-tensor scale for the scores, and each layer's operand
for the val loss (the step below the configured bfloat16).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from portbench.reference.data import Split, first_unique
from portbench.reference.train import (N_RETRIES, _fp8, bpr, epoch_seed, propagate,
                                       sym_weights)

ROW = ("val_loss", "precision", "recall", "f1", "ndcg", "H", "I")


@dataclass
class EvalData:
    n_users: int
    n_items: int
    train_mask: torch.Tensor  # (U, I) bool
    train_inter: torch.Tensor  # (U, I) float32 0/1
    item_deg: torch.Tensor  # (I,) float64, train rows
    val_mask: torch.Tensor  # (U, I) bool
    val_rows: torch.Tensor  # (U,) float64, val rows a user
    veu: torch.Tensor  # deduplicated val edges, first occurrence first
    vei: torch.Tensor
    vweight: torch.Tensor  # float64


def eval_data(split: Split, device) -> EvalData:
    U, I = split.n_users, split.n_items

    def mask(users, items):
        m = torch.zeros((U, I), dtype=torch.bool, device=device)
        m[torch.from_numpy(users).to(device), torch.from_numpy(items).to(device)] = True
        return m

    train_mask = mask(split.train_users, split.train_items)
    vu, vi = first_unique(split.val_users, split.val_items, I)
    veu, vei = torch.from_numpy(vu).to(device), torch.from_numpy(vi).to(device)
    return EvalData(
        U, I, train_mask, train_mask.float(),
        torch.from_numpy(np.bincount(split.train_items, minlength=I)).to(device).double(),
        mask(split.val_users, split.val_items),
        torch.from_numpy(np.bincount(split.val_users, minlength=U)).to(device).double(),
        veu, vei, sym_weights(veu, vei, U, I))


def val_loss(data: EvalData, tables, cfg: dict, seed: int, epoch: int, precision: str):
    """(val loss, its scale): the scale is the magnitude of its two terms,
    mean softplus plus the regularizer, against which its gap is read (the
    loss itself crosses zero as training goes on)."""
    dev = data.veu.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(epoch_seed(seed, cfg["epochs"] + epoch))
    E, I = data.veu.shape[0], data.n_items
    cands = torch.randint(0, I, (N_RETRIES, E), generator=gen, device=dev)
    collide = data.val_mask[data.veu[None, :], cands]
    neg = cands.gather(0, torch.argmax((~collide).int(), dim=0)[None, :])[0]
    fu, fi = propagate(tables[0], tables[1], data.veu, data.vei, data.vweight, cfg["layers"],
                       precision)
    loss = bpr(tables, fu, fi, data.veu, data.vei, neg, cfg["epsilon"])
    no_reg = bpr(tables, fu, fi, data.veu, data.vei, neg, 0.0)
    reg = float(loss - no_reg)
    return float(loss), -float(no_reg) + abs(reg)


def internal_similarity(data: EvalData, rec: torch.Tensor, block: int = 512) -> float:
    U, k = rec.shape
    uniq, inv = torch.unique(rec, return_inverse=True)
    sub = data.train_inter[:, uniq]
    cooc = (sub.T @ sub).double()  # integer counts, exact in float32
    deg = data.item_deg[uniq]
    inv_sqrt = torch.where(deg > 0, deg.clamp_min(1).rsqrt(), 0.0)
    S = cooc * inv_sqrt[:, None] * inv_sqrt[None, :]
    total = 0.0
    for s in range(0, U, block):
        r = inv[s:s + block]
        pair = S[r[:, :, None], r[:, None, :]]
        total += float(pair.sum() - torch.diagonal(pair, dim1=1, dim2=2).sum())
    return total / (U * k * (k - 1))


def evaluate(data: EvalData, tables, cfg: dict, seed: int, epoch: int,
             precision: str = "float64") -> dict:
    """The row of ``ROW`` and ``val_loss_scale`` for ``tables`` (users,
    items) at the record of ``epoch``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = data.veu.device
    tables = [t.to(dev, torch.float64) for t in tables]
    loss, scale = val_loss(data, tables, cfg, seed, epoch, precision)
    ue, ie = (_fp8(t) for t in tables) if precision == "fp8" else tables
    k = cfg["k"]
    scores = (ue @ ie.T).masked_fill_(data.train_mask, -math.inf)
    rec = torch.topk(scores, k, dim=1).indices
    del scores
    hits = data.val_mask.gather(1, rec).double()
    present = data.val_rows > 0
    n_present = float(present.sum().clamp_min(1))
    n_hit = hits.sum(1)
    p = float(n_hit[present].sum()) / n_present / k
    r = float((n_hit / data.val_rows.clamp_min(1))[present].sum()) / n_present
    discount = 1.0 / torch.log2(torch.arange(2, k + 2, dtype=torch.float64, device=dev))
    ndcg = float(((hits * discount).sum(1) / discount.sum())[present].sum()) / n_present
    U = rec.shape[0]
    counts = torch.bincount(rec.reshape(-1), minlength=data.n_items).double()
    h = 1.0 - float((counts * counts).sum() - U * k) / (U * (U - 1) * k)
    row = dict(zip(ROW, (loss, p, r, 2 * p * r / (p + r) if p + r else 0.0, ndcg, h,
                         internal_similarity(data, rec))))
    row["val_loss_scale"] = scale
    return row

"""The fused LGCNHS serving score, in plain PyTorch, for a sample of users.

Independent of the program; what it follows is the reference repository's
SpreadLightGCN (``model/SpreadLightGCN/model.py:55-153``) and HybridS
(``model/SpreadMethod/model.py:14-99``):

  A      the train+val interactions (0/1), seen = A > 0
  G      = user_table . item_table^T (layer 0)
  W      = (A^T / k_user) . A / (k_item^(1-lambda) (x) k_item^lambda)
  F      = A . W
  score  = G * F, seen items excluded, the top k of each user

worked out in float64 with the sparse A and without the (I, I) W:
F = ((A D1) . An^T) . (A D2), D1 = diag(k_item^-(1-lambda)),
D2 = diag(k_item^-lambda), An = A / k_user; a zero degree's row and
column are zero on both sides. ``precision="bfloat16"`` is the control,
the step below the served float32: G and F rounded to bfloat16 and their
product taken in bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.data import Split, first_unique


def _sparse(rows, cols, vals, shape, device):
    idx = torch.stack([torch.from_numpy(rows), torch.from_numpy(cols)]).to(device)
    return torch.sparse_coo_tensor(idx, vals, shape).coalesce()


def fused_scores(split: Split, user_emb: torch.Tensor, item_emb: torch.Tensor, lam: float,
                 users: np.ndarray, precision: str = "float64") -> torch.Tensor:
    """(len(users), I) scores, seen items at -inf."""
    U, I = split.n_users, split.n_items
    dev = user_emb.device
    su, si = first_unique(np.concatenate([split.train_users, split.val_users]),
                          np.concatenate([split.train_items, split.val_items]), I)
    ones = torch.ones(su.shape[0], dtype=torch.float64, device=dev)
    k_user = torch.bincount(torch.from_numpy(su).to(dev), minlength=U).double()
    k_item = torch.bincount(torch.from_numpy(si).to(dev), minlength=I).double()
    d1 = torch.where(k_item > 0, k_item.clamp_min(1) ** -(1.0 - lam), 0.0)
    d2 = torch.where(k_item > 0, k_item.clamp_min(1) ** -lam, 0.0)
    u_t = torch.from_numpy(su).to(dev)
    i_t = torch.from_numpy(si).to(dev)
    An_T = _sparse(si, su, ones / k_user[u_t].clamp_min(1), (I, U), dev)  # (A / k_user)^T
    AD2_T = _sparse(si, su, d2[i_t], (I, U), dev)  # (A D2)^T

    rows = torch.from_numpy(np.asarray(users, np.int64)).to(dev)
    A_s = torch.zeros((rows.shape[0], I), dtype=torch.float64, device=dev)
    mine = torch.isin(u_t, rows)
    where = torch.searchsorted(torch.sort(rows).values, u_t[mine])
    order = torch.argsort(rows)
    A_s[order[where], i_t[mine]] = 1.0
    M = torch.sparse.mm(An_T.t().coalesce(), (A_s * d1[None, :]).t()).t()  # (S, U)
    F = torch.sparse.mm(AD2_T, M.t()).t()  # (S, I)
    G = user_emb[rows].double() @ item_emb.double().t()
    if precision == "bfloat16":
        Gb = user_emb[rows].bfloat16() @ item_emb.bfloat16().t()
        score = (Gb * F.bfloat16()).double()
    else:
        score = G * F
    return score.masked_fill(A_s > 0, -torch.inf)


def top_lists(scores: torch.Tensor, k: int) -> np.ndarray:
    """The top k of each row, ties to the lowest index."""
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    return order.cpu().numpy()

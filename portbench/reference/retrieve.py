"""The LightGCN[Opti] retrieval score, in plain PyTorch, for a sample of users.

Independent of the program; what it follows is the reference repository's
``model/LightGCN/recommend.py:68-125``:

  score  = user_table . item_table^T (layer 0)
  the train+val interactions excluded, the top k of each user

worked out in float64 (TF32 off). Seen items read -inf, so that
``judge.score_gap`` reads a served seen item as inf: the program's finite
-1024 sentinel reaches a list only past a user's unseen items, which no
judged configuration runs out of. ``precision="bfloat16"`` is the
control, the step below the served float32: both tables rounded to
bfloat16 and their product taken in bfloat16.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.reference.data import Split, first_unique


def layer0_scores(split: Split, user_emb: torch.Tensor, item_emb: torch.Tensor,
                  users: np.ndarray, precision: str = "float64") -> torch.Tensor:
    """(len(users), I) scores, seen items at -inf."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    users = np.asarray(users, np.int64)
    su, si = first_unique(np.concatenate([split.train_users, split.val_users]),
                          np.concatenate([split.train_items, split.val_items]), split.n_items)
    rows = torch.from_numpy(users).to(user_emb.device)
    if precision == "bfloat16":
        score = (user_emb[rows].bfloat16() @ item_emb.bfloat16().t()).double()
    else:
        score = user_emb[rows].double() @ item_emb.double().t()
    mine = np.isin(su, users)
    order = np.argsort(users, kind="stable")
    at = order[np.searchsorted(users[order], su[mine])]
    score[torch.from_numpy(at), torch.from_numpy(si[mine])] = -torch.inf
    return score

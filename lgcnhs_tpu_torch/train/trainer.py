"""Checkpoint IO of the trainer.

Port of ``lgcnhs_tpu/train/trainer.save_checkpoint`` / ``load_checkpoint``
(``:1070-1083``): the same npz keys, so a checkpoint the JAX trainer wrote
serves here unchanged. Training itself is not ported yet.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams


def save_checkpoint(path: str, params: LightGCNParams) -> None:
    """Final-params checkpoint as plain arrays (``user_emb``, ``item_emb``)."""
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

"""Resource-diffusion operators (ProbS / HeatS / HybridS).

Port of the dense operators of ``lgcnhs_tpu/ops/diffusion.py`` (reference
``model/SpreadMethod/model.py:14-99``). The JAX package leaves them to XLA,
not Pallas; here they are plain ``torch.matmul`` and elementwise ops. f32
products must run in full f32: entry points set
``torch.backends.cuda.matmul.allow_tf32 = False``.

  W_gen = (A^T / k_user) . A                      (model.py:14-27)
  ProbS:   W = W_gen / k_item[col]                (model.py:30-43)
  HeatS:   W = W_gen / k_item[row]                (model.py:46-60)
  HybridS: W = W_gen / (k_i^(1-l) (x) k_j^l)      (model.py:63-85)
  F = A . W                                       (model.py:88-99)

Zero degrees are clamped to 1 exactly as the reference does; ``0**0 == 1``,
so HybridS(l=0/1) degenerates to HeatS/ProbS.
"""
from __future__ import annotations

import torch


def general_spreading_matrix(A: torch.Tensor) -> torch.Tensor:
    """W_gen = (A^T / k_user) . A (``model/SpreadMethod/model.py:14-27``)."""
    k_user = A.sum(dim=1)
    k_user = torch.where(k_user == 0, torch.ones_like(k_user), k_user)
    return (A / k_user[:, None]).T @ A


def _item_degrees(A: torch.Tensor) -> torch.Tensor:
    return A.sum(dim=0)


def probs_transfer(A: torch.Tensor, W_gen: torch.Tensor) -> torch.Tensor:
    """Column-normalized mass-conserving spreading (``model.py:30-43``)."""
    k_item = _item_degrees(A)
    k_item = torch.where(k_item == 0, torch.ones_like(k_item), k_item)
    return W_gen / k_item[None, :]


def heats_transfer(A: torch.Tensor, W_gen: torch.Tensor) -> torch.Tensor:
    """Row-normalized heat diffusion (``model.py:46-60``)."""
    k_item = _item_degrees(A)
    k_item = torch.where(k_item == 0, torch.ones_like(k_item), k_item)
    return W_gen / k_item[:, None]


def hybrid_transfer(A: torch.Tensor, W_gen: torch.Tensor, lam) -> torch.Tensor:
    """W = W_gen / (k_i^(1-l) (x) k_j^l); l=1 is ProbS, l=0 is HeatS
    (``model.py:63-85``). ``lam`` is taken in A's dtype, as the JAX callers
    pass it, so ``1 - lam`` rounds the same way."""
    lam = torch.as_tensor(lam, dtype=A.dtype, device=A.device)
    k_item = _item_degrees(A)
    denom = torch.pow(k_item, 1.0 - lam)[:, None] * torch.pow(k_item, lam)[None, :]
    denom.masked_fill_(denom == 0, 1.0)  # in place: no second (I, I) temporary
    return W_gen / denom


def resource(A: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Second diffusion pass F = A . W (``model.py:88-99``)."""
    return A @ W


def hybrid_resource(A: torch.Tensor, W_gen: torch.Tensor, lam) -> torch.Tensor:
    """F = A . HybridS(A, W_gen, l), the reference's ``getHybridSResourceMat``
    (``model/SpreadLightGCN/model.py:106-120``)."""
    return resource(A, hybrid_transfer(A, W_gen, lam))

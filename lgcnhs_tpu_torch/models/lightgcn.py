"""LightGCN embedding tables.

Port of the serving slice of ``lgcnhs_tpu/models/lightgcn.py``: the two
layer-0 tables, their two initializations, and layer-0 scoring.
Recommendation-time scoring uses the LAYER-0 tables, not the propagated
means (reference ``model/LightGCN/evaluation.py:31-34``) -- a quirk that is
load-bearing for parity, and the reason serving needs no propagation.

torch cannot reproduce ``jax.random`` streams, so the initializers take an
explicit ``torch.Generator`` and draw on the CPU (the same numbers whatever
``device`` the tables land on); ``init_lightgcn_opti`` also accepts an
injected projection so both packages can start from the same tables.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class LightGCNParams(NamedTuple):
    user_emb: torch.Tensor  # (U, D) e_u^0
    item_emb: torch.Tensor  # (I, D) e_i^0


def init_lightgcn(
    generator: torch.Generator,
    n_users: int,
    n_items: int,
    embedding_dim: int = 64,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> LightGCNParams:
    """N(0, 0.1^2) init (``model/LightGCN/model.py:32-38``)."""
    u = 0.1 * torch.randn(n_users, embedding_dim, generator=generator)
    i = 0.1 * torch.randn(n_items, embedding_dim, generator=generator)
    return LightGCNParams(u.to(device, dtype), i.to(device, dtype))


Projection = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def init_lightgcn_opti(
    generator: Optional[torch.Generator],
    user_features: np.ndarray,  # (U, Fu)
    item_features: np.ndarray,  # (I, Fi)
    embedding_dim: int = 64,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
    projection: Optional[Projection] = None,
) -> LightGCNParams:
    """Feature-projection init, the LightGCNOpti delta
    (``model/LightGCNOpti/model.py:35-49``): one random dense projection of
    the side features seeds the tables. W and b follow torch ``Linear``'s
    default U(-1/sqrt(fan_in), 1/sqrt(fan_in)) unless ``projection`` injects
    ``(Wu (Fu, D), bu (D,), Wi (Fi, D), bi (D,))``."""
    uf = torch.tensor(np.asarray(user_features, np.float32))
    itf = torch.tensor(np.asarray(item_features, np.float32))

    def draw(fan_in: int) -> Tuple[torch.Tensor, torch.Tensor]:
        bound = 1.0 / np.sqrt(fan_in)
        W = torch.empty(fan_in, embedding_dim).uniform_(-bound, bound, generator=generator)
        b = torch.empty(embedding_dim).uniform_(-bound, bound, generator=generator)
        return W, b

    if projection is None:
        Wu, bu = draw(uf.shape[1])
        Wi, bi = draw(itf.shape[1])
    else:
        Wu, bu, Wi, bi = (torch.tensor(np.asarray(p, np.float32)) for p in projection)
    return LightGCNParams(
        (uf @ Wu + bu).to(device, dtype), (itf @ Wi + bi).to(device, dtype)
    )


def params_from_jax(user_emb, item_emb, device: torch.device | str) -> LightGCNParams:
    """The JAX package's ``LightGCNParams`` tables (any array numpy can read)
    as the port's tables on ``device``, dtype kept."""
    return LightGCNParams(
        torch.tensor(np.asarray(user_emb), device=device),
        torch.tensor(np.asarray(item_emb), device=device),
    )


def layer0_scores(params: LightGCNParams) -> torch.Tensor:
    """Full preference matrix from the LAYER-0 tables
    (``model/LightGCN/evaluation.py:31-34``)."""
    return params.user_emb @ params.item_emb.T

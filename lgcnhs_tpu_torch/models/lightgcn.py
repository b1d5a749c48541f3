"""LightGCN: embedding tables, forward, BPR loss and samplers.

Port of ``lgcnhs_tpu/models/lightgcn.py``: the two layer-0 tables, their two
initializations, the K-layer forward, the reference's sign-flipped BPR and
the two negative samplers, and layer-0 scoring. Recommendation-time scoring
uses the LAYER-0 tables, not the propagated means (reference
``model/LightGCN/evaluation.py:31-34``) -- a quirk that is load-bearing for
parity, and the reason serving needs no propagation.

torch cannot reproduce ``jax.random`` streams, so the initializers and
samplers take an explicit ``torch.Generator``. The initializers draw on the
CPU (the same numbers whatever ``device`` the tables land on); the samplers
draw on the generator's device. ``init_lightgcn_opti`` also accepts an
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


def lightgcn_forward(
    params: LightGCNParams, R_hat: torch.Tensor, n_layers: int = 3
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e_u^final, e_i^final): mean over propagation layers 0..K
    (``model/LightGCN/model.py:40-74``)."""
    from lgcnhs_tpu_torch.ops.propagation import lightgcn_propagate

    return lightgcn_propagate(params.user_emb, params.item_emb, R_hat, n_layers)


def bpr_loss(
    users_final: torch.Tensor,
    users_0: torch.Tensor,
    pos_final: torch.Tensor,
    pos_0: torch.Tensor,
    neg_final: torch.Tensor,
    neg_0: torch.Tensor,
    epsilon: float,
    batch_size: Optional[int] = None,
) -> torch.Tensor:
    """Reference BPR (``model/LightGCN/loss.py:12-44``) with its sign flip,
    ``-mean(softplus(pos - neg))``, plus epsilon times the squared norms of
    the batch's LAYER-0 rows. softplus as ``logaddexp(x, 0)``, the form
    ``jax.nn.softplus`` takes. ``batch_size`` set: the rows are a slice of
    a batch of that size and the mean's denominator is the whole batch's,
    so the slices' values sum to the batch's loss (the mesh's data axis)."""
    reg = epsilon * (
        torch.sum(users_0 * users_0) + torch.sum(pos_0 * pos_0) + torch.sum(neg_0 * neg_0)
    )
    pos_scores = torch.sum(users_final * pos_final, dim=-1)
    neg_scores = torch.sum(users_final * neg_final, dim=-1)
    diff = pos_scores - neg_scores
    softplus = torch.logaddexp(diff, torch.zeros_like(diff))
    bpr = -torch.mean(softplus) if batch_size is None else -torch.sum(softplus) / batch_size
    return bpr + reg


def _first_clean_candidate(cands: torch.Tensor, collide: torch.Tensor) -> torch.Tensor:
    """Per column, the candidate of the first round that does not collide
    (round 0 when every round collides, as ``argmax`` of all-False)."""
    first_ok = torch.argmax((~collide).to(torch.int32), dim=0)
    return cands.gather(0, first_ok[None, :])[0]


def sample_bpr_batch(
    generator: torch.Generator,
    edge_users: torch.Tensor,  # (E,) int64
    edge_items: torch.Tensor,  # (E,) int64
    pos_mask: torch.Tensor,  # (U, I) bool, true positives for rejection
    batch_size: int,
    n_items: int,
    n_retries: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(users, pos_items, neg_items) triples: ``batch_size`` edges uniform
    with replacement (``loss.py:64``), each with a uniform negative rejected
    against the user's positives (``loss.py:58``). All ``n_retries``
    candidate rounds are drawn at once and each sample takes its first
    non-colliding one (residual collision probability density^n_retries).
    Draws from ``generator``, on its device (the tensors' device)."""
    dev = edge_users.device
    n_edges = edge_users.shape[0]
    idx = torch.randint(0, n_edges, (batch_size,), generator=generator, device=dev)
    users = edge_users[idx]
    pos_items = edge_items[idx]
    cands = torch.randint(0, n_items, (n_retries, batch_size), generator=generator, device=dev)
    collide = pos_mask[users[None, :], cands]  # (R, B)
    return users, pos_items, _first_clean_candidate(cands, collide)


def sample_negatives_for_edges(
    generator: torch.Generator,
    edge_users: torch.Tensor,  # (E,)
    edge_items: torch.Tensor,  # (E,)
    pos_mask: torch.Tensor,  # (U, I) bool, this split's positives
    n_items: int,
    n_retries: int = 8,
    reject_user_ids: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(users, pos_items, neg_items) covering EVERY edge exactly once, in
    edge order, one rejected negative each: the reference ``calValLoss``
    sampling (``model/LightGCN/evaluation.py:68-77``), with the one-shot
    ``n_retries`` draw of ``sample_bpr_batch``. ``reject_user_ids`` also
    rejects a candidate equal to the edge's USER id (``calValLoss``'s
    ``contains_neg_self_loops=False``; set by ``neg_range='reference'``)."""
    E = edge_users.shape[0]
    cands = torch.randint(0, n_items, (n_retries, E), generator=generator,
                          device=edge_users.device)
    collide = pos_mask[edge_users[None, :], cands]  # (R, E)
    if reject_user_ids:
        collide = collide | (cands == edge_users[None, :])
    return edge_users, edge_items, _first_clean_candidate(cands, collide)

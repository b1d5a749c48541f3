"""Vectorized metric kernels: precision, recall, NDCG, Hamming diversity and
Sorensen internal similarity.

Port of the dense metrics of ``lgcnhs_tpu/ops/metrics_ops.py`` (``:26-157``)
that the trainer's validation uses. The reference loops over users and item
pairs (``metrics/accurate.py``, ``metrics/diversity.py``); here
- precision/recall/NDCG are one gather (the hit matrix) and masked means;
- Hamming's pairwise-overlap double sum is ||c||^2 of the item
  recommendation-count vector c, O(U k) instead of O(U^2 k);
- internal similarity is the bilinear form b_u^T S b_u over the
  degree-normalized co-occurrence matrix S.
Everything is computed in f32, as the JAX functions do.
"""
from __future__ import annotations

import torch


def hit_matrix(rec: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """(U, k) 0/1 f32 hits: rec item in the user's positive set
    (``metrics/accurate.py:26-33``)."""
    return torch.gather(pos.to(torch.float32), 1, rec.long())


def precision_recall_from_hits(
    hits: torch.Tensor,  # (U, k) 0/1
    pos_counts: torch.Tensor,  # (U,) |pos_u| row counts
    present: torch.Tensor,  # (U,) bool, users with >= 1 positive in the split
):
    """P@k and R@k, means over present users only
    (``metrics/accurate.py:26-42``)."""
    num_correct = torch.sum(hits, dim=1)
    m = present.to(torch.float32)
    n_present = torch.clamp(torch.sum(m), min=1.0)
    k = hits.shape[1]
    precision = torch.sum(num_correct * m) / n_present / k
    safe_counts = torch.clamp(pos_counts.to(torch.float32), min=1.0)
    recall = torch.sum(num_correct / safe_counts * m) / n_present
    return precision, recall


def precision_recall(rec, pos, pos_counts, present):
    return precision_recall_from_hits(hit_matrix(rec, pos), pos_counts, present)


def ndcg_from_hits(hits: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    """Binary-relevance NDCG with log2 discount; IDCG marks all k slots
    relevant (``metrics/accurate.py:76-86``)."""
    k = hits.shape[1]
    discount = 1.0 / torch.log2(
        torch.arange(2, k + 2, dtype=torch.float32, device=hits.device)
    )
    dcg = torch.sum(hits * discount[None, :], dim=1)
    ndcg = dcg / torch.sum(discount)
    m = present.to(torch.float32)
    return torch.sum(ndcg * m) / torch.clamp(torch.sum(m), min=1.0)


def ndcg_at_k(rec, pos, present) -> torch.Tensor:
    return ndcg_from_hits(hit_matrix(rec, pos), present)


def hamming_distance(rec: torch.Tensor, n_items: int) -> torch.Tensor:
    """Mean over ordered user pairs of 1 - |rec_i ^ rec_j| / k
    (``metrics/diversity.py:15-63``): H = 1 - (||c||^2 - U k) / (U (U-1) k).
    The denominator is a float (U (U-1) k overflows int32 past ~60k users)."""
    U, k = rec.shape
    counts = torch.zeros(n_items, dtype=torch.float32, device=rec.device)
    counts.index_add_(0, rec.reshape(-1).long(),
                      torch.ones(U * k, dtype=torch.float32, device=rec.device))
    off_diag = torch.sum(counts * counts) - U * k
    return 1.0 - off_diag / (float(U) * (U - 1) * k)


def similarity_matrix(interaction: torch.Tensor, item_deg: torch.Tensor) -> torch.Tensor:
    """S[i, j] = cooc(i, j) / sqrt(k_i k_j), cooc = A^T A in f32
    (``metrics/diversity.py:96-107``); zero-degree items get 0."""
    A = interaction.to(torch.float32)
    cooc = A.T @ A
    deg = item_deg.to(torch.float32)
    inv_sqrt = torch.where(deg > 0, torch.rsqrt(deg), torch.zeros_like(deg))
    return cooc * inv_sqrt[:, None] * inv_sqrt[None, :]


def internal_similarity(
    rec: torch.Tensor,  # (U, k)
    interaction: torch.Tensor,  # (U, I) 0/1
    item_deg: torch.Tensor,  # (I,)
) -> torch.Tensor:
    """Sorensen intra-list similarity (``metrics/diversity.py:66-115``):
    (1 / (U k (k-1))) sum_u sum_{i != j in rec_u} S[i, j], as
    sum(B S * B) minus the diagonal, B the (U, I) one-hot of the lists."""
    U, k = rec.shape
    S = similarity_matrix(interaction, item_deg)
    B = torch.zeros((U, interaction.shape[1]), dtype=torch.float32, device=rec.device)
    B.scatter_(1, rec.long(), 1.0)
    quad = torch.sum((B @ S) * B)
    diag_term = torch.sum(B * torch.diagonal(S)[None, :])
    return (quad - diag_term) / (float(U) * k * (k - 1))

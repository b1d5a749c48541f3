"""LightGCN K-layer graph propagation, dense.

Port of ``lgcnhs_tpu/ops/propagation.lightgcn_propagate`` (``:31-70``). The
joint (U+I)-node graph is bipartite, so with R_hat = D_u^-1/2 R D_i^-1/2 one
propagation step is

    e_u' = R_hat   . e_i
    e_i' = R_hat^T . e_u

and the final embedding is the mean over layers 0..K
(``model/LightGCN/model.py:60-72``). The sparse and bucketed paths of the
JAX module belong to the large-graph slice (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Tuple

import torch


def lightgcn_propagate(
    user_emb: torch.Tensor,  # (U, D) e_u^0
    item_emb: torch.Tensor,  # (I, D) e_i^0
    R_hat: torch.Tensor,  # (U, I) normalized bipartite incidence
    n_layers: int = 3,
    bf16_matmul: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(e_u^final, e_i^final), the per-side layer mean.

    Without ``bf16_matmul`` every product runs at the operands' precision
    (f32 or f64; f32 matmuls on the card need TF32 off, the port's
    default). With it, the mixed-precision flavor of the JAX function
    (``preferred_element_type=f32``): R_hat and each layer's right operand
    are rounded to bf16, the products (exact in f32) summed in f32, and the
    result f32. ``torch.matmul`` of two bf16 tensors would round its output
    to bf16, so the bf16-valued operands are widened to f32 first."""
    eu, ei = user_emb, item_emb
    acc_u, acc_i = eu, ei
    if bf16_matmul:
        Rl = R_hat.to(torch.bfloat16).float()

        def dot(a, b):
            return a @ b.to(torch.bfloat16).float()
    else:
        Rl = R_hat

        def dot(a, b):
            return a @ b
    for _ in range(n_layers):
        eu, ei = dot(Rl, ei), dot(Rl.T, eu)
        acc_u = acc_u + eu
        acc_i = acc_i + ei
    scale = 1.0 / (n_layers + 1)
    return acc_u * scale, acc_i * scale

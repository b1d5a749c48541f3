"""Experimental feature-autoencoder recommenders (reference ``waste/model/``).

Port of ``lgcnhs_tpu/models/experimental.py``: the three prototypes the
reference author explored before settling on LightGCN, as functions on
tensors under the JAX names:

- the GCN autoencoder: a 2-layer GCN over the joint user-item graph
  (``joint_normalized_adj``, ``gcn_autoencoder_forward``) trained to
  reconstruct the node features with MSE (``waste/model/GNN.py:20-199``);
- the GAT autoencoder: a bipartite graph-attention stack, one attention
  layer each direction a layer (``_gat_layer``, ``gat_autoencoder_forward``;
  ``waste/model/HeteroGAT.py:21-224``);
- ``hybrid_gat_fusion``: GAT scores Hadamard-fused with HybridS diffusion,
  the precursor of the LGCNHS fusion (``waste/model/HybridSHeteroGAT.py``).

No hand kernel runs here: the products are dense ``torch.matmul`` in full
f32 (TF32 off, PyTorch's default, which the CLIs also set), as the JAX file
leaves them to plain XLA. torch cannot reproduce ``jax.random``, so ``init_autoencoder`` draws
from an explicit ``torch.Generator`` (on the CPU: the same numbers whatever
the device) and ``train_autoencoder`` also takes injected parameters
(``init=``), such as the JAX package's through
``experimental_params_from_jax``. The optimizer is ``torch.optim.Adam``, the
pair ``docs/PARITY.md`` section 2.6 pins optax's Adam to.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lgcnhs_tpu_torch.ops.diffusion import diffusion_scores
from lgcnhs_tpu_torch.runtime.device import resolve_device

KINDS = ("gcn", "gat")


class MLPGraphParams(NamedTuple):
    W1: torch.Tensor  # (F, H)
    b1: torch.Tensor  # (H,)
    W2: torch.Tensor  # (H, F)
    b2: torch.Tensor  # (F,)
    # attention vectors (GAT only; drawn for GCN too, unused there)
    a1: torch.Tensor  # (2H,)
    a2: torch.Tensor  # (2F,)


def _glorot(generator: torch.Generator, shape) -> torch.Tensor:
    fan_in, fan_out = shape[0], shape[-1]
    scale = math.sqrt(6.0 / (fan_in + fan_out))
    return (2.0 * torch.rand(shape, generator=generator) - 1.0) * scale


def init_autoencoder(
    generator: torch.Generator,
    feature_dim: int,
    hidden_dim: int,
) -> MLPGraphParams:
    """Glorot-uniform weights and zero biases, drawn on the CPU in the order
    W1, W2, a1, a2. The attention vectors are drawn as (2H, 1) and (2F, 1)
    columns, so their Glorot fans are (2H, 1) and (2F, 1), then flattened.
    The tensors stay on the CPU; ``train_autoencoder`` places them."""
    return MLPGraphParams(
        W1=_glorot(generator, (feature_dim, hidden_dim)),
        b1=torch.zeros(hidden_dim),
        W2=_glorot(generator, (hidden_dim, feature_dim)),
        b2=torch.zeros(feature_dim),
        a1=_glorot(generator, (2 * hidden_dim, 1))[:, 0],
        a2=_glorot(generator, (2 * feature_dim, 1))[:, 0],
    )


def experimental_params_from_jax(params, device: torch.device | str) -> MLPGraphParams:
    """The JAX package's ``MLPGraphParams`` (any arrays numpy can read) as the
    port's on ``device``, dtypes kept."""
    return MLPGraphParams(*(torch.tensor(np.asarray(t), device=device) for t in params))


def joint_normalized_adj(R: torch.Tensor, self_loops: bool = True) -> torch.Tensor:
    """(U+I) x (U+I) symmetric-normalized joint adjacency, self-loops
    included (torch-geometric GCNConv's default, used by
    ``waste/model/GNN.py``); 0 where a degree is 0."""
    U, I = R.shape
    N = U + I
    A = R.new_zeros((N, N))
    A[:U, U:] = R
    A[U:, :U] = R.T
    if self_loops:
        A += torch.eye(N, dtype=R.dtype, device=R.device)
    deg = A.sum(dim=1)
    inv = torch.where(deg > 0, torch.rsqrt(deg), torch.zeros_like(deg))
    return A * inv[:, None] * inv[None, :]


def gcn_autoencoder_forward(
    params: MLPGraphParams, A_hat: torch.Tensor, X: torch.Tensor
) -> torch.Tensor:
    """relu(A_hat X W1) -> A_hat H W2 (``waste/model/GNN.py:39-44``)."""
    H = torch.relu(A_hat @ (X @ params.W1) + params.b1)
    return A_hat @ (H @ params.W2) + params.b2


def _gat_layer(x_dst, x_src, R_mask, W, b, a):
    """Single-head GAT message pass src -> dst over a bipartite mask:
    attention logits a^T [W h_dst || W h_src] through LeakyReLU(0.2),
    softmax over the dst row's neighbours (GATConv semantics). A row with no
    neighbour is all -inf, its softmax NaN, set to 0: ``where`` passes a zero
    cotangent to the masked branch, so the backward stays finite there."""
    h_dst = x_dst @ W + b
    h_src = x_src @ W + b
    d = h_dst.shape[1]
    logits = (h_dst @ a[:d])[:, None] + (h_src @ a[d:])[None, :]
    logits = torch.where(logits >= 0, logits, 0.2 * logits)  # jax.nn.leaky_relu
    logits = torch.where(R_mask > 0, logits, -math.inf)
    att = torch.softmax(logits, dim=1)
    att = torch.where(torch.isnan(att), 0.0, att)
    return att @ h_src


def gat_autoencoder_forward(
    params: MLPGraphParams,
    R: torch.Tensor,  # (U, I) 0/1 incidence
    Xu: torch.Tensor,
    Xi: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two attention layers each direction, relu between: the HeteroConv
    GATConv stack of ``waste/model/HeteroGAT.py``. W1, b1, a1 serve both
    directions of the first layer, W2, b2, a2 of the second."""
    Hu = torch.relu(_gat_layer(Xu, Xi, R, params.W1, params.b1, params.a1))
    Hi = torch.relu(_gat_layer(Xi, Xu, R.T, params.W1, params.b1, params.a1))
    Zu = _gat_layer(Hu, Hi, R, params.W2, params.b2, params.a2)
    Zi = _gat_layer(Hi, Hu, R.T, params.W2, params.b2, params.a2)
    return Zu, Zi


def _joint_inputs(R, Xu, Xi, dtype: torch.dtype, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R in f32, X = [Xu; Xi] as f32 values in ``dtype``: float32, or
    float64 beside f64 parameters, as JAX promotes them) on ``device``. The
    joint graph needs one feature space: the narrower side is zero-padded."""
    Xu, Xi = np.asarray(Xu), np.asarray(Xi)
    width = max(Xu.shape[1], Xi.shape[1])
    Xu = np.pad(Xu, ((0, 0), (0, width - Xu.shape[1])))
    Xi = np.pad(Xi, ((0, 0), (0, width - Xi.shape[1])))
    X = torch.tensor(np.vstack([Xu, Xi]).astype(np.float32), device=device)
    R = torch.tensor(np.asarray(R, np.float32), device=device)
    return R, X.to(torch.promote_types(torch.float32, dtype))


def train_autoencoder(
    R: np.ndarray,  # (U, I) interaction matrix
    Xu: np.ndarray,
    Xi: np.ndarray,
    hidden_dim: int = 64,
    lr: float = 1e-3,
    epochs: int = 100,
    seed: int = 42,
    kind: str = "gcn",
    init: Optional[MLPGraphParams] = None,
    device: torch.device | str = "cuda",
) -> Tuple[MLPGraphParams, List[float]]:
    """MSE feature-reconstruction training (``waste/model/GNN.py:74-115``):
    the MSE to the input for ``gcn``, the sum of the user and the item MSE
    for ``gat``; full-batch Adam at ``lr``, one step an epoch. Starts from
    ``init`` when given, else from ``init_autoencoder`` seeded with ``seed``.
    Returns the parameters and the loss of each epoch, before its step."""
    if kind not in KINDS:
        raise ValueError(f"kind must be 'gcn' or 'gat', got {kind!r}")
    device = resolve_device(device)
    U = R.shape[0]
    R, X = _joint_inputs(R, Xu, Xi, torch.float32 if init is None else init.W1.dtype, device)
    if init is None:
        init = init_autoencoder(torch.Generator().manual_seed(seed), X.shape[1], hidden_dim)
    params = MLPGraphParams(*(t.detach().to(device).clone().requires_grad_(True)
                              for t in init))
    optimizer = torch.optim.Adam(params, lr=lr)

    if kind == "gcn":
        A_hat = joint_normalized_adj(R).to(X.dtype)

        def loss_fn():
            out = gcn_autoencoder_forward(params, A_hat, X)
            return torch.mean((out - X) ** 2)

    else:
        Xu_t, Xi_t = X[:U], X[U:]

        def loss_fn():
            Zu, Zi = gat_autoencoder_forward(params, R, Xu_t, Xi_t)
            return torch.mean((Zu - Xu_t) ** 2) + torch.mean((Zi - Xi_t) ** 2)

    history = []
    for _ in range(epochs):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        optimizer.step()
        history.append(loss.item())
    return MLPGraphParams(*(p.detach() for p in params)), history


def autoencoder_scores(
    params: MLPGraphParams, R: np.ndarray, Xu: np.ndarray, Xi: np.ndarray,
    kind: str = "gcn",
) -> torch.Tensor:
    """(U, I) f32 preference scores, the dot of the reconstructed node
    embeddings (``waste/model/GNN.py:118-160`` flavor), on the parameters'
    device."""
    R, X = _joint_inputs(R, Xu, Xi, params.W1.dtype, params.W1.device)
    U = R.shape[0]
    if kind == "gcn":
        Z = gcn_autoencoder_forward(params, joint_normalized_adj(R).to(X.dtype), X)
        Zu, Zi = Z[:U], Z[U:]
    else:
        Zu, Zi = gat_autoencoder_forward(params, R, X[:U], X[U:])
    return (Zu @ Zi.T).to(torch.float32)


def hybrid_gat_fusion(
    params: MLPGraphParams, R: np.ndarray, Xu: np.ndarray, Xi: np.ndarray,
    lam: float,
) -> torch.Tensor:
    """GAT preference scores Hadamard-fused with HybridS diffusion, G * F:
    the LGCNHS precursor (``waste/model/HybridSHeteroGAT.py``), F at f32 by
    the dense ``ops/diffusion.diffusion_scores``."""
    G = autoencoder_scores(params, R, Xu, Xi, kind="gat")
    A = torch.tensor(np.asarray(R, np.float32), device=G.device)
    return G * diffusion_scores(A, torch.tensor(lam, dtype=torch.float32))

"""Resource-diffusion operators (ProbS / HeatS / HybridS).

Port of ``lgcnhs_tpu/ops/diffusion.py`` (reference
``model/SpreadMethod/model.py:14-99``): the dense operators, the two
W-free algorithms (blocked, user-factored) and the size dispatch between
them. The JAX package leaves them to XLA, not Pallas; here they are plain
``torch.matmul`` and elementwise ops. f32 products must run in full f32:
entry points set ``torch.backends.cuda.matmul.allow_tf32 = False``.

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


def blend_exponents(lam, dtype: torch.dtype, device) -> tuple:
    """(1 - l, l) as 0-d tensors of ``dtype``. A Python ``lam`` is taken in
    ``dtype`` first; a tensor ``lam`` forms ``1 - l`` in its own dtype, as
    JAX forms ``1.0 - lam`` in the grid's dtype before ``jnp.power``
    promotes it (an f32 grid over f64 tables, the JAX
    ``ops/sweep._blended_transfer``)."""
    if not torch.is_tensor(lam):
        lam = torch.as_tensor(lam, dtype=dtype)
    lam = lam.to(device)
    return (1.0 - lam).to(dtype), lam.to(dtype)


def hybrid_transfer(A: torch.Tensor, W_gen: torch.Tensor, lam) -> torch.Tensor:
    """W = W_gen / (k_i^(1-l) (x) k_j^l); l=1 is ProbS, l=0 is HeatS
    (``model.py:63-85``), the exponents from ``blend_exponents``."""
    one_minus, lam = blend_exponents(lam, A.dtype, A.device)
    k_item = _item_degrees(A)
    denom = torch.pow(k_item, one_minus)[:, None] * torch.pow(k_item, lam)[None, :]
    denom.masked_fill_(denom == 0, 1.0)  # in place: no second (I, I) temporary
    return W_gen / denom


def resource(A: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Second diffusion pass F = A . W (``model.py:88-99``)."""
    return A @ W


def hybrid_resource(A: torch.Tensor, W_gen: torch.Tensor, lam) -> torch.Tensor:
    """F = A . HybridS(A, W_gen, l), the reference's ``getHybridSResourceMat``
    (``model/SpreadLightGCN/model.py:106-120``)."""
    return resource(A, hybrid_transfer(A, W_gen, lam))


def diffusion_scores(A: torch.Tensor, lam, transpose_w: bool = False) -> torch.Tensor:
    """F from the raw interaction matrix through a dense (I, I) W.
    ``transpose_w`` reproduces the reference's dataset overrides that
    transpose W_gen before blending (ProbS on movielens, HeatS on douban;
    ``model/SpreadMethod/recommend.py:87-105``)."""
    W_gen = general_spreading_matrix(A)
    if transpose_w:
        W_gen = W_gen.T
    return hybrid_resource(A, W_gen, lam)


def _blend_factors(A: torch.Tensor, lam):
    """(A / k_user, k_item^(1-l), k_item^l): the user normalization and the
    row and column scalings of the HybridS blend (``blend_exponents``)."""
    one_minus, lam = blend_exponents(lam, A.dtype, A.device)
    k_user = A.sum(dim=1)
    k_user = torch.where(k_user == 0, torch.ones_like(k_user), k_user)
    k_item = _item_degrees(A)
    return A / k_user[:, None], torch.pow(k_item, one_minus), torch.pow(k_item, lam)


def blocked_diffusion_scores(
    A: torch.Tensor, lam, block: int = 512, transpose_w: bool = False
) -> torch.Tensor:
    """F = A . HybridS(W_gen) by item-column blocks, so the (I, I) W never
    exists: block j forms T_j = An^T A[:, j] (I x B; ``A^T An[:, j]`` when
    transposed), scales it by the degree blend and contracts F[:, j] = A T_j.
    Peak extra memory one (I, B) block. Falls back to ``diffusion_scores``
    when ``block`` does not divide I (padding the item axis would change the
    degree vectors), as the JAX function does."""
    U, I = A.shape
    if I % block != 0:
        return diffusion_scores(A, lam, transpose_w=transpose_w)
    An, alpha, beta = _blend_factors(A, lam)
    F = torch.empty((U, I), dtype=A.dtype, device=A.device)
    for j0 in range(0, I, block):
        if transpose_w:
            T = A.T @ An[:, j0:j0 + block]
        else:
            T = An.T @ A[:, j0:j0 + block]
        denom = alpha[:, None] * beta[None, j0:j0 + block]
        denom.masked_fill_(denom == 0, 1.0)
        F[:, j0:j0 + block] = A @ (T / denom)
    return F


def user_factored_diffusion_scores(
    A: torch.Tensor, lam, transpose_w: bool = False
) -> torch.Tensor:
    """F = A . HybridS(W_gen, l) with no item x item intermediate. The blend
    is a diagonal congruence W = D1 W_gen D2 (D1 = diag(k^-(1-l)), D2 =
    diag(k^-l)) and W_gen = An^T A, so

        F = (A D1 . An^T) . (A D2)        -- this op
        F = (A D1 . A^T) . (An D2)        -- transposed W_gen

    with one (U, U) product: 2 U^2 I operations against U I^2, better
    whenever 2U < I. It differs from ``diffusion_scores`` only in sum order.
    Clamping each factor's zero degree is exact: a zero-degree item's W row
    and column are zero either way."""
    An, alpha, beta = _blend_factors(A, lam)
    a_inv = 1.0 / torch.where(alpha == 0, torch.ones_like(alpha), alpha)
    b_inv = 1.0 / torch.where(beta == 0, torch.ones_like(beta), beta)
    left = A * a_inv[None, :]
    if transpose_w:
        M = left @ A.T
        right = An * b_inv[None, :]
    else:
        M = left @ An.T
        right = A * b_inv[None, :]
    del left, An
    return M @ right


# One (I, I) array this large and the dense transfer-matrix path stops; the
# JAX package's figure (sized for a 16 GB TPU), kept so that both packages
# pick the same algorithm, and so the same sum order, for a shape.
DENSE_TRANSFER_BUDGET_BYTES = int(4e9)


def choose_diffusion(
    n_users: int, n_items: int, itemsize: int = 4, budget_bytes: int | None = None
) -> str:
    """Dispatch rule of ``diffusion_scores_auto``, budgeting each layout's
    whole live set:

    - "dense" (the reference's operation order): 2 (I, I) + 3 (U, I);
    - "factored" (2U < I): 1 (U, U) + 3 (U, I);
    - "blocked": 3 (U, I);
    - "sharded": nothing on one device fits.

    ``budget_bytes=None`` reads ``DENSE_TRANSFER_BUDGET_BYTES`` at call time."""
    if budget_bytes is None:
        budget_bytes = DENSE_TRANSFER_BUDGET_BYTES
    ui = n_users * n_items * itemsize
    ii = n_items * n_items * itemsize
    if 2 * ii + 3 * ui <= budget_bytes:
        return "dense"
    if 2 * n_users < n_items and factored_fits(n_users, n_items, itemsize, budget_bytes):
        return "factored"
    if 3 * ui <= budget_bytes:
        return "blocked"
    return "sharded"


def factored_fits(
    n_users: int, n_items: int, itemsize: int = 4, budget_bytes: int | None = None
) -> bool:
    """The memory gate of the factored path alone: its (U, U) product and
    three (U, I) arrays fit the budget (read at call time when None)."""
    if budget_bytes is None:
        budget_bytes = DENSE_TRANSFER_BUDGET_BYTES
    return (n_users * n_users + 3 * n_users * n_items) * itemsize <= budget_bytes


def diffusion_scores_auto(
    A: torch.Tensor, lam, transpose_w: bool = False, block: int = 512
) -> torch.Tensor:
    """``diffusion_scores`` where the dense path fits the budget, else the
    W-free factored or blocked algorithm (``choose_diffusion``); raises when
    no single-device layout fits, naming the mesh route, as JAX does."""
    choice = choose_diffusion(A.shape[0], A.shape[1], A.element_size())
    if choice == "dense":
        return diffusion_scores(A, lam, transpose_w=transpose_w)
    if choice == "factored":
        return user_factored_diffusion_scores(A, lam, transpose_w=transpose_w)
    if choice == "blocked":
        return blocked_diffusion_scores(A, lam, block=block, transpose_w=transpose_w)
    raise ValueError(
        f"diffusion at U={A.shape[0]} x I={A.shape[1]} ({A.dtype}) exceeds the "
        f"single-device budget ({DENSE_TRANSFER_BUDGET_BYTES / 1e9:.1f} GB) in every "
        "layout; even the streamed one needs three (U, I) arrays. Run on a mesh "
        "(parallel.sharding.sharded_diffusion_scores / cli.find_lambda --mesh, one "
        "rank a device under torchrun), or raise "
        "ops.diffusion.DENSE_TRANSFER_BUDGET_BYTES if the device fits the footprint."
    )

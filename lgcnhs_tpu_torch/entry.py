"""The port's counterpart of ``__graft_entry__``.

- ``entry(device="cuda")``: the flagship forward step (LGCNHS =
  SpreadLightGCNOpti) and its inputs, ``(forward_step, (params, A, seen,
  lam))``: layer-0 preference scores -> HybridS diffusion -> Hadamard fusion
  -> the spread ranker's top-k, through ``models/fusion.fused_recommend``
  (library ops, no hand kernel, as JAX's ``entry()`` reaches no Pallas
  kernel). The inputs are ``__graft_entry__``'s: the seeded ``_toy_problem``
  graph (64 users x 128 items, 512 draws, D=16) and tables drawn from
  ``np.random.default_rng(1)``, user table first, λ=0.6, k=10.
- ``dryrun_multichip(n)``: the mesh path on n CPU ranks
  (``parallel/dryrun.py``).

    python -m lgcnhs_tpu_torch.entry [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from lgcnhs_tpu_torch.data.graph import EdgeSet, interaction_matrix, pos_bool_matrix
from lgcnhs_tpu_torch.models.fusion import fused_recommend
from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams
from lgcnhs_tpu_torch.parallel.dryrun import dryrun_multichip
from lgcnhs_tpu_torch.runtime.device import resolve_device

__all__ = ["dryrun_multichip", "entry"]


def _toy_problem(n_users=64, n_items=128, n_edges=512, emb=16, seed=0):
    rng = np.random.default_rng(seed)
    eu = rng.integers(0, n_users, n_edges).astype(np.int32)
    ei = rng.integers(0, n_items, n_edges).astype(np.int32)
    pairs = np.unique(np.stack([eu, ei]), axis=1)
    return pairs[0], pairs[1], n_users, n_items, emb


def forward_step(params: LightGCNParams, A: torch.Tensor, seen: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """One LGCNHS forward: the (U, 10) int32 lists."""
    return fused_recommend(params, A, seen, lam, k=10)


def entry(device: torch.device | str = "cuda"):
    """(forward_step, example_args) on ``device``; raises without CUDA
    unless the CPU is asked for."""
    device = resolve_device(device)
    eu, ei, U, I, D = _toy_problem()
    rng = np.random.default_rng(1)
    params = LightGCNParams(
        user_emb=torch.from_numpy(rng.standard_normal((U, D)).astype(np.float32)).to(device),
        item_emb=torch.from_numpy(rng.standard_normal((I, D)).astype(np.float32)).to(device),
    )
    es = EdgeSet(eu, ei)
    A = torch.from_numpy(interaction_matrix(U, I, es)).to(device)
    seen = torch.from_numpy(pos_bool_matrix(U, I, es)).to(device)
    lam = torch.tensor(0.6, dtype=torch.float32, device=device)
    return forward_step, (params, A, seen, lam)


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Run the flagship forward step once.")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    fn, args = entry(parser.parse_args().device)
    print("entry OK:", tuple(fn(*args).shape))

"""Mid-train checkpoints: save and restore the full training state.

Port of ``lgcnhs_tpu/train/checkpoint.py``. The JAX package writes its
(params, optax state) pytree with orbax; the port writes the same state as
one npz an epoch: both tables, and per table Adam's ``exp_avg``,
``exp_avg_sq`` and ``step`` (``torch.optim.Adam``'s state), with the epoch.

- ``<checkpoint_dir>/<epoch>/state.npz``, written to a temporary file and
  moved into place with ``os.replace``, so a checkpoint is whole or absent;
- the three newest epochs are kept (orbax's ``max_to_keep=3``);
- ``restore_train_state`` returns the newest whole checkpoint (or a given
  epoch) as ``(epoch, params, optimizer_state)``, or None when there is none;
- arrays keep their dtype and bits, so save-then-restore is bitwise.

``train_state_from_jax`` carries a JAX run's state across: optax
``inject_hyperparams(adam)``'s ``inner_state[0]`` is
``ScaleByAdamState(count, mu, nu)`` (``lgcnhs_tpu/train/trainer.py:84-92``),
and torch's Adam keeps the same moments under other names (``mu`` is
``exp_avg``, ``nu`` is ``exp_avg_sq``, ``count`` is ``step``); the padded
leaves of a table-sharded mesh run are cut to the true catalog.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from lgcnhs_tpu_torch.models.lightgcn import LightGCNParams

MAX_TO_KEEP = 3
STATE_FILE = "state.npz"
TABLES = LightGCNParams._fields  # ("user_emb", "item_emb")
MOMENTS = ("exp_avg", "exp_avg_sq", "step")

#: {table: {"exp_avg": tensor, "exp_avg_sq": tensor, "step": 0-d tensor}}
OptimizerState = Dict[str, Dict[str, torch.Tensor]]


def optimizer_state(optimizer: torch.optim.Adam, params: LightGCNParams) -> OptimizerState:
    """Adam's per-table state of ``params``' tables (after a first step)."""
    return {name: {m: optimizer.state[t][m] for m in MOMENTS}
            for name, t in zip(TABLES, params)}


def load_optimizer_state(optimizer: torch.optim.Adam, params: LightGCNParams,
                         state: OptimizerState) -> None:
    """Put ``state`` in as Adam's state of ``params``' tables: the moments on
    the table's device in the table's dtype (checked), ``step`` as saved."""
    for name, t in zip(TABLES, params):
        s = state[name]
        for m in ("exp_avg", "exp_avg_sq"):
            if s[m].shape != t.shape or s[m].dtype != t.dtype:
                raise ValueError(f"{name}.{m}: checkpoint {tuple(s[m].shape)} {s[m].dtype}, "
                                 f"table {tuple(t.shape)} {t.dtype}")
        optimizer.state[t] = {"step": s["step"].clone().cpu(),
                              "exp_avg": s["exp_avg"].to(t.device).clone(),
                              "exp_avg_sq": s["exp_avg_sq"].to(t.device).clone()}


def _epochs(path: str):
    """Epochs of the whole checkpoints under ``path``, ascending."""
    if not os.path.isdir(path):
        return []
    return sorted(int(d) for d in os.listdir(path)
                  if d.isdigit() and os.path.exists(os.path.join(path, d, STATE_FILE)))


def save_train_state(path: str, epoch: int, params: LightGCNParams,
                     opt_state: OptimizerState) -> str:
    """Checkpoint the full training state after ``epoch``; keeps the
    ``MAX_TO_KEEP`` newest. Returns the file written."""
    arrays = {"epoch": np.asarray(epoch, np.int64)}
    for name, t in zip(TABLES, params):
        arrays[name] = t.detach().cpu().numpy()
        for m in MOMENTS:
            arrays[f"{name}.{m}"] = opt_state[name][m].detach().cpu().numpy()
    target = os.path.join(path, str(int(epoch)))
    os.makedirs(target, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=target, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, os.path.join(target, STATE_FILE))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    for old in _epochs(path)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(path, str(old)), ignore_errors=True)
    return os.path.join(target, STATE_FILE)


def restore_train_state(
    path: str, device: torch.device | str = "cpu", epoch: Optional[int] = None,
) -> Optional[Tuple[int, LightGCNParams, OptimizerState]]:
    """(epoch, params, optimizer_state) of the newest checkpoint under
    ``path`` (or of ``epoch``), tables and moments on ``device``; None when
    there is no checkpoint."""
    epochs = _epochs(path)
    if epoch is None:
        if not epochs:
            return None
        epoch = epochs[-1]
    elif epoch not in epochs:
        return None
    with np.load(os.path.join(path, str(epoch), STATE_FILE)) as data:
        params = LightGCNParams(*(torch.from_numpy(data[name]).to(device) for name in TABLES))
        state = {name: {m: torch.from_numpy(data[f"{name}.{m}"]) for m in MOMENTS}
                 for name in TABLES}
        saved_epoch = int(data["epoch"])
    for name in TABLES:
        for m in ("exp_avg", "exp_avg_sq"):
            state[name][m] = state[name][m].to(device)
    return saved_epoch, params, state


def train_state_from_jax(params, opt_state, n_users: Optional[int] = None,
                         n_items: Optional[int] = None) -> Tuple[LightGCNParams, OptimizerState]:
    """A JAX run's (``LightGCNParams``, ``inject_hyperparams(adam)`` state),
    leaves as numpy arrays (``jax.tree.map(np.asarray, ...)``), as the port's
    (params, optimizer_state) on the CPU, dtypes kept.

    A mesh run that row-shards its tables (the dense mesh plan, or
    ``compute.coo_table_sharding``) checkpoints leaves padded to its model
    axis. They load as they are on a port mesh of the same model axis;
    ``n_users`` and ``n_items`` cut the tables and both moments to the true
    catalog, for one device. The rows cut must be zero, as a padded row
    stays under Adam; a ValueError says otherwise."""
    adam = opt_state.inner_state[0]  # ScaleByAdamState(count, mu, nu)
    step = torch.tensor(float(np.asarray(adam.count)), dtype=torch.float32)
    keep = dict(zip(TABLES, (n_users, n_items)))

    def leaf(tree, name, what):
        a = np.asarray(getattr(tree, name))
        n = keep[name]
        if n is not None:
            if a[n:].any():
                raise ValueError(f"{name} {what}: rows past {n} are not zero padding")
            a = a[:n]
        return torch.tensor(a)

    tables = LightGCNParams(*(leaf(params, n, "table") for n in TABLES))
    state = {n: {"exp_avg": leaf(adam.mu, n, "mu"), "exp_avg_sq": leaf(adam.nu, n, "nu"),
                 "step": step.clone()} for n in TABLES}
    return tables, state

"""The (data, model) mesh on ``torch.distributed``.

Port of ``lgcnhs_tpu/runtime/mesh.py``. JAX runs one controller over many
devices and names them in a ``jax.sharding.Mesh``; the port runs one
process (rank) per device and names the ranks in a ``DeviceMesh``
(``torch.distributed.device_mesh.init_device_mesh``) with the dims
``("data", "model")``:

- each rank takes ``cuda:{LOCAL_RANK}``, or the CPU when the CPU is asked
  for; the group runs on NCCL on CUDA and on gloo on the CPU, never one in
  place of the other;
- dense BPR math is data-parallel over "data"; embedding tables are
  row-sharded and the (U, I) operands item-sharded over "model"
  (``parallel/sharding.py``).

A rank holds only its block of a sharded operand. The placement helpers
(``replicated``, ``row_sharded``, ``col_sharded``, ``batch_sharded``) cut
that block out of a global array; each names, in its docstring, the process
group the array is split over. The collectives that join blocks are
explicit (``parallel/sharding.py``).

Only rank 0 writes artifacts, checkpoints, CSVs and the log file
(``is_writer``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_axes() -> Tuple[str, str]:
    return (DATA_AXIS, MODEL_AXIS)


def world_size() -> int:
    """Ranks in the default process group; 1 when there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the default process group; 0 when there is none."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_writer() -> bool:
    """True on the rank that writes files and prints results: rank 0, or
    the one process of a run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the process group; nothing without one."""
    if dist.is_initialized():
        dist.barrier()


def backend_for(device: torch.device | str) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> int:
    """Start the default process group (``jax.distributed.initialize``'s
    counterpart) and return the world size.

    The arguments default to the variables ``torchrun`` sets (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``/``MASTER_PORT`` through ``env://``);
    ``coordinator_address`` may be ``host:port`` or a full init method
    (``tcp://...``, ``file://...``). One process sets up nothing; a group
    that already exists is kept. A CUDA rank takes ``cuda:{LOCAL_RANK}``
    and NCCL, a CPU rank gloo."""
    if dist.is_initialized():
        return dist.get_world_size()
    n = num_processes if num_processes is not None else int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1:
        return 1
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = backend_for(device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank % max(1, torch.cuda.device_count())))
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=n, rank=rank)
    return n


class Mesh:
    """A (data, model) grid of ranks: the ``DeviceMesh`` and this rank's
    place in it. ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does; ``devices`` is the grid of global
    ranks; ``device`` is this rank's torch device."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.axis_names = mesh_axes()
        self.devices = device_mesh.mesh.cpu().numpy()
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def group(self, axis: str):
        """The process group along ``axis`` that holds this rank."""
        return self.device_mesh.get_group(axis)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return int(self.device_mesh.get_local_rank(axis))

    def peer(self, axis: str, i: int) -> int:
        """Global rank of the rank at coordinate ``i`` along ``axis`` whose
        other coordinate is this rank's."""
        if axis == MODEL_AXIS:
            return int(self.devices[self.index(DATA_AXIS), i])
        return int(self.devices[i, self.index(MODEL_AXIS)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _mesh_device(device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(mesh_shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A (data, model) mesh over the ranks of the default process group.

    With no shape, every rank on the model axis (table sharding binds
    first: the catalog axes outgrow a card, not the batch). The ranks'
    device follows the group's backend: NCCL ranks on their CUDA device,
    gloo ranks on the CPU. A world-1 mesh needs a process group too
    (``chip_smoke.py`` starts one from a file store)."""
    from torch.distributed.device_mesh import init_device_mesh

    n_ranks = world_size()
    if mesh_shape is None:
        mesh_shape = (1, n_ranks)
    mesh_shape = tuple(int(x) for x in mesh_shape)
    n_needed = mesh_shape[0] * mesh_shape[1]
    if n_needed > n_ranks:
        raise ValueError(f"mesh {mesh_shape} needs {n_needed} devices, have {n_ranks}")
    if n_needed < n_ranks:
        raise ValueError(
            f"mesh {mesh_shape} spans {n_needed} of the {n_ranks} ranks; every rank "
            "of the process group takes part in the mesh"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_mesh = init_device_mesh(device_type, mesh_shape, mesh_dim_names=mesh_axes())
    return Mesh(device_mesh, _mesh_device(device_type))


def mesh_from_config(compute) -> Optional[Mesh]:
    """The mesh the flagship path trains and serves on, from
    ``ComputeConfig.mesh_shape``: ``(1, 1)`` (the default) is one device
    and gives None; ``(0, 0)`` ("auto") puts every rank on the model axis
    and gives None at world size 1; any other shape is taken as it is and
    must match the world size. Ranks come from the launcher: without a
    process group a shape of more than one rank raises, naming ``torchrun``."""
    shape = tuple(int(x) for x in compute.mesh_shape)
    if shape == (1, 1):
        return None
    n_ranks = world_size()
    if shape == (0, 0):
        if n_ranks == 1:
            return None
        shape = (1, n_ranks)
    n_needed = shape[0] * shape[1]
    if not dist.is_initialized():
        if n_needed > 1:
            raise ValueError(
                f"mesh {shape} needs {n_needed} ranks and no process group is running: "
                f"start one process per device, e.g. `torchrun --nproc-per-node "
                f"{n_needed} -m lgcnhs_tpu_torch.cli.main --mesh {shape[0]},{shape[1]}`"
            )
    elif n_needed != n_ranks:
        raise ValueError(
            f"mesh {shape} needs {n_needed} ranks, the process group has {n_ranks}"
        )
    return make_mesh(shape)


def spawn_ranks(target, n: int, tmp: str, args: tuple = (), timeout: float = 600.0) -> None:
    """Run ``target(rank, n, store, *args)`` in ``n`` spawned processes, the
    ranks of one process group joined through the file store ``store`` in
    the directory ``tmp`` (fresh for each group). Raises when a rank fails
    or the ranks outlast ``timeout`` seconds; no process outlives the call."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=target, args=(r, n, store, *args)) for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} of {n} failed "
                           f"(exit codes {[procs[r].exitcode for r in failed]})")


def _block(mesh: Mesh, n: int, axis: str) -> slice:
    parts = mesh.shape[axis]
    if n % parts:
        raise ValueError(f"a dim of {n} does not split over the {parts} ranks of {axis!r}; "
                         "pad it first (parallel.sharding.padded_catalog)")
    size = n // parts
    i = mesh.index(axis)
    return slice(i * size, (i + 1) * size)


def _on(mesh: Mesh, x) -> torch.Tensor:
    """A contiguous copy of ``x`` on the rank's device: a block never keeps
    the global array it was cut from alive (a CPU slice would be a view)."""
    return torch.as_tensor(x).to(mesh.device, memory_format=torch.contiguous_format, copy=True)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """The whole array on every rank (no group splits it)."""
    return _on(mesh, x)


def row_sharded(mesh: Mesh, x) -> torch.Tensor:
    """This rank's rows, split over ``mesh.group(MODEL_AXIS)``: the embedding
    tables (U, D) and (I, D)."""
    x = torch.as_tensor(x)
    return _on(mesh, x[_block(mesh, x.shape[0], MODEL_AXIS)])


def col_sharded(mesh: Mesh, x) -> torch.Tensor:
    """This rank's columns, split over ``mesh.group(MODEL_AXIS)``: the (U, I)
    incidence, masks and score matrices by item blocks, the (I, I)
    operators by output-item blocks."""
    x = torch.as_tensor(x)
    return _on(mesh, x[:, _block(mesh, x.shape[1], MODEL_AXIS)])


def batch_sharded(mesh: Mesh, x) -> torch.Tensor:
    """This rank's slice of the leading dim, split over
    ``mesh.group(DATA_AXIS)``: minibatch index arrays, in contiguous slices
    (``torch.tensor_split``: a batch that does not divide the axis gives the
    first ranks one row more)."""
    x = torch.as_tensor(x)
    part = torch.tensor_split(x, mesh.shape[DATA_AXIS])[mesh.index(DATA_AXIS)]
    return _on(mesh, part)

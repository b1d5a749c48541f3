"""LGCNHS on PyTorch and CUDA: ``lgcnhs_tpu`` ported to one NVIDIA Hopper
card, slice by slice.

The package mirrors ``lgcnhs_tpu``'s module names so each counterpart is easy
to find, and imports neither JAX nor ``lgcnhs_tpu``:

- ``config``    -- dataclass config matrix (a copy of ``lgcnhs_tpu.config``)
- ``runtime``   -- logging, stage timing, device resolution, artifact cache,
                   pandas-free CSV tables, the minimal xlsx writer, and the
                   (data, model) mesh on ``torch.distributed``
- ``parallel``  -- the mesh's sharded training, distributed top-k, sharded
                   diffusion, and a CPU dry run of it
- ``data``      -- seeded synthesis, rating pipeline and graph arrays (numpy)
- ``models``    -- LightGCN tables, the spread and fusion models, dispatch
- ``train``     -- the trainer (one device, or a mesh), npz checkpoints and
                   mid-train resume
- ``eval``      -- the six metrics with the reference's rounding
- ``ops``       -- diffusion, ranking, metrics, propagation, and ``ops.cuda``:
                   the hand-written Hopper kernels with their plain twins
- ``cli``       -- ``python -m lgcnhs_tpu_torch.cli.main`` (the pipeline),
                   ``cli.retrieve`` (serving), ``cli.find_lambda`` (the
                   lambda sweep), ``cli.evaluate`` (the cross-model report)
                   and ``cli.ablation`` (its chart)
- ``entry``     -- ``__graft_entry__``'s counterpart: the flagship forward
                   step ``entry()`` and ``dryrun_multichip``

Entry points run on ``cuda`` unless the CPU is asked for (``--device cpu``);
with ``--mesh`` one process a device, started by ``torchrun``.
"""

__version__ = "0.1.0"

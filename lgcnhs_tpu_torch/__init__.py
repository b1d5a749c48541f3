"""LGCNHS on PyTorch and CUDA: ``lgcnhs_tpu`` ported to one NVIDIA Hopper
card, slice by slice.

The package mirrors ``lgcnhs_tpu``'s module names so each counterpart is easy
to find, and imports neither JAX nor ``lgcnhs_tpu``:

- ``config``    -- dataclass config matrix (a copy of ``lgcnhs_tpu.config``)
- ``runtime``   -- logging, stage timing, device resolution, artifact cache
- ``data``      -- seeded synthesis, rating pipeline and graph arrays (numpy)
- ``models``    -- LightGCN tables, the spread and fusion models, dispatch
- ``train``     -- the single-device trainer and npz checkpoints
- ``eval``      -- the six metrics with the reference's rounding
- ``ops``       -- diffusion, ranking, metrics, propagation, and ``ops.cuda``:
                   the hand-written Hopper kernels with their plain twins
- ``cli``       -- ``python -m lgcnhs_tpu_torch.cli.main`` (the pipeline)
                   and ``python -m lgcnhs_tpu_torch.cli.retrieve`` (serving)

Entry points run on ``cuda`` unless the CPU is asked for (``--device cpu``).
"""

__version__ = "0.1.0"

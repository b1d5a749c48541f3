"""LGCNHS on PyTorch and CUDA: the serving path of ``lgcnhs_tpu`` ported to
one NVIDIA Hopper card.

The package mirrors ``lgcnhs_tpu``'s module names so each counterpart is easy
to find, and imports neither JAX nor ``lgcnhs_tpu``:

- ``config``    -- dataclass config matrix (a copy of ``lgcnhs_tpu.config``)
- ``runtime``   -- logging and stage timing
- ``data``      -- seeded synthesis, rating pipeline and graph arrays (numpy)
- ``models``    -- LightGCN tables, LGCNHS fused serving, checkpoint dispatch
- ``train``     -- npz checkpoints (training itself is not ported yet)
- ``ops``       -- diffusion operators, top-k ranking, and ``ops.cuda``: the
                   hand-written Hopper kernels with their plain twins
- ``cli``       -- ``python -m lgcnhs_tpu_torch.cli.retrieve``

Entry points run on ``cuda`` unless the CPU is asked for (``--device cpu``).
"""

__version__ = "0.1.0"

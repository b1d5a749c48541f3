"""``serve.contraction_share``: the contraction rows kernel 4's launches
walked in the traced window over the rows the dense walk would have walked,
in %: 100 x the window's ``fused_lgcnhs_serve.k_rows`` over its
``fused_lgcnhs_serve.k_rows_dense``, the program's counters
(``lgcnhs_tpu_torch/ops/cuda/fusion_serve``). The dense walk reads 100; the
compacted walk, which contracts each 128-user block over its users' items
alone, reads the share of the catalog those items are. Nothing is read
where the window counts no launch. A program without the counters gets no
``COUNTERS`` here, and the metric reads nothing."""
from lgcnhs_tpu_torch.ops.cuda.fusion_serve import fused_lgcnhs_serve

PROGRAM = "lgcnhs_tpu_torch.ops.cuda.fusion_serve"
COUNTERS = ({"k_rows": f"{PROGRAM}:fused_lgcnhs_serve.k_rows",
             "k_rows_dense": f"{PROGRAM}:fused_lgcnhs_serve.k_rows_dense"}
            if hasattr(fused_lgcnhs_serve, "k_rows")
            and hasattr(fused_lgcnhs_serve, "k_rows_dense") else {})


def read(ctx):
    dense = ctx.counts.get("k_rows_dense", 0)
    if not dense:
        return None
    return 100.0 * ctx.counts["k_rows"] / dense

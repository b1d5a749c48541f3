"""``serve.h2d_mb_per_pass``: the bytes the program hands the card a
serving pass, in MB (1e6 B): the traced window's ``serve_fused.h2d_bytes``
over its ``serve_fused.passes``, the program's counters
(``lgcnhs_tpu_torch/models/fusion``). A and seen (f32 and bool) make it
5 U I / 1e6. A program without the counters gets no ``COUNTERS`` here, and
the metric reads nothing."""
from lgcnhs_tpu_torch.models.fusion import serve_fused

PROGRAM = "lgcnhs_tpu_torch.models.fusion"
COUNTERS = ({"serve_passes": f"{PROGRAM}:serve_fused.passes",
             "serve_h2d_bytes": f"{PROGRAM}:serve_fused.h2d_bytes"}
            if hasattr(serve_fused, "passes") and hasattr(serve_fused, "h2d_bytes") else {})


def read(ctx):
    passes = ctx.counts.get("serve_passes", 0)
    if not passes:
        return None
    return ctx.counts["serve_h2d_bytes"] / passes / 1e6

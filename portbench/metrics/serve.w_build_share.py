"""``serve.w_build_share``: over the program's ``serve.pass`` spans that end
in the traced window, the time inside their ``serve.w_block`` spans (one
block of W^T's bf16 parts built from the edges: its sparse product and its
split, launched from the host) over the time inside them, in %
(``spans.share_of_outer``), read where the window's
``serve_fused.w_blocks`` counter (``lgcnhs_tpu_torch/models/fusion``)
counts a block. A program without the counter gets no ``COUNTERS`` here,
and the metric reads nothing."""
from lgcnhs_tpu_torch.models.fusion import serve_fused
from portbench import spans

COUNTERS = ({"w_blocks": "lgcnhs_tpu_torch.models.fusion:serve_fused.w_blocks"}
            if hasattr(serve_fused, "w_blocks") else {})


def read(ctx):
    if not ctx.counts.get("w_blocks", 0):
        return None
    return spans.share_of_outer(ctx.view, "serve.pass", "serve.w_block")

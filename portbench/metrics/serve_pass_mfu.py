"""``serve_pass_mfu``: the traced window's serving passes per second times
the FLOPs a pass needs, over the card's bf16 peak, in %.

A pass's FLOPs, from shapes alone, are those of the fused score:
2 U I D (G) and 2 nnz I (A W over A's nonzeros); W's own product is left
out, so the share is a floor of the pass's."""


def pass_flops(shapes) -> float:
    return 2.0 * shapes["U"] * shapes["I"] * shapes["D"] + 2.0 * shapes["nnz"] * shapes["I"]


def read(ctx):
    passes = ctx.view.within(ctx.records.get("passes", []))
    if not passes or not ctx.view.device_ops:
        return None
    rate = len(passes) / ctx.view.window_s
    return 100.0 * rate * pass_flops(ctx.shapes) / ctx.peaks["bf16_flops_per_s"]

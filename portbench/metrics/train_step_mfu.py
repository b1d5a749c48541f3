"""``train_step_mfu``: the traced window's training rate times the FLOPs a
step needs, over the card's bf16 peak, in %.

A step's FLOPs, from shapes alone: 2L propagations (L forward, L in the
backward), each 4 nnz D (nnz normalized train edges, both directions of
the bipartite product, a multiply and an add each), so 8 L nnz D; the BPR
terms (O(batch D)) are left out. Everything else in the window (evaluation,
job set-up, captures) counts as time without work, so the share is the
whole job's, not a kernel's."""


def step_flops(shapes) -> float:
    return 8.0 * shapes["L"] * shapes["nnz"] * shapes["D"]


def read(ctx):
    intervals = ctx.view.within(ctx.records.get("intervals", []), lambda r: r.end_ns)
    if not intervals or not ctx.view.device_ops:
        return None
    steps = sum(iv.epochs for iv in intervals)
    rate = steps / ctx.view.window_s
    return 100.0 * rate * step_flops(ctx.shapes) / ctx.peaks["bf16_flops_per_s"]

"""``fused_serve_roofline``: the least time one fused serving launch
needs, over its device time, in %.

Its work, from shapes alone (U users, I items, nnz train+val pairs, D, k):
it reads the seen graph once (A and the mask are the same pairs), the
smaller of a bitmap (U I / 8 bytes) and an edge list (8 nnz bytes), the two
tables at 2 bytes ((U + I) D 2) and W at 2 bytes (I I 2), and writes the
lists, int32 ids and f32 scores (U k 8 bytes); FLOPs 2 U I D (G) and
2 nnz I (A W over A's nonzeros). The least time is the larger of bytes over
the HBM peak and FLOPs over the bf16 peak. The device time of a launch is
that of ``fusion_serve.cu``'s kernels (``fused_serve_kernel`` and the
operand split ``bf16_parts_kernel``) over the window's launches; read only
where the trace's ``fused_serve_kernel`` events equal the launch count."""

COUNTERS = {"fused_lgcnhs_serve":
            "lgcnhs_tpu_torch.ops.cuda.fusion_serve:fused_lgcnhs_serve.launches"}


def work(shapes):
    U, I, nnz, D, k = shapes["U"], shapes["I"], shapes["nnz"], shapes["D"], shapes["k"]
    graph = min(U * I / 8.0, 8.0 * nnz)
    flops = 2.0 * U * I * D + 2.0 * nnz * I
    return flops, graph + (U + I) * D * 2.0 + I * I * 2.0 + U * k * 8.0


def least_seconds(shapes, peaks) -> float:
    flops, nbytes = work(shapes)
    return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])


def read(ctx):
    launches = ctx.counts.get("fused_lgcnhs_serve", 0)
    mains = ctx.view.kernels_named("fused_serve_kernel")
    if launches == 0 or len(mains) != launches:
        return None
    ops = ctx.view.kernels_named("fused_serve_kernel", "bf16_parts_kernel")
    per_launch = sum(e - s for _, s, e in ops) / 1e9 / launches
    return 100.0 * least_seconds(ctx.shapes, ctx.peaks) / per_launch

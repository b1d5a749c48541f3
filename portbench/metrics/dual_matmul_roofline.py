"""``dual_matmul_roofline``: the least time one ``dual_matmul`` launch
needs, over its device time, in %.

Its work, from shapes alone (U users, I items, nnz train edges, D): it
reads the graph once, the smaller of a bitmap (U I / 8 bytes) and an edge
list (8 nnz bytes), the two bf16 operand tables ((U + I) D 2 bytes), and
writes the two f32 products ((U + I) D 4 bytes); FLOPs 4 nnz D (both
products, a multiply and an add per edge and column). The least time is the
larger of bytes over the HBM peak and FLOPs over the bf16 peak. The device
time of a launch is that of its kernels, ``dual_kernel`` and the split-K
``dual_reduce_kernel``, over the window's launches; read only where the
trace's ``dual_kernel`` events equal the wrapper's launch count."""

COUNTERS = {"dual_matmul": "lgcnhs_tpu_torch.ops.cuda.propagation:dual_matmul.launches"}


def work(shapes):
    U, I, nnz, D = shapes["U"], shapes["I"], shapes["nnz"], shapes["D"]
    graph = min(U * I / 8.0, 8.0 * nnz)
    return 4.0 * nnz * D, graph + (U + I) * D * 2.0 + (U + I) * D * 4.0


def least_seconds(shapes, peaks) -> float:
    flops, nbytes = work(shapes)
    return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])


def read(ctx):
    launches = ctx.counts.get("dual_matmul", 0)
    mains = ctx.view.kernels_named("dual_kernel")
    if launches == 0 or len(mains) != launches:
        return None
    ops = ctx.view.kernels_named("dual_kernel", "dual_reduce_kernel")
    per_launch = sum(e - s for _, s, e in ops) / 1e9 / launches
    return 100.0 * least_seconds(ctx.shapes, ctx.peaks) / per_launch

"""``fused_topk_roofline``: the least time one fused retrieval launch
(kernel 2) needs, over its device time, in %.

Its work, from shapes alone (U users, I items, nnz train+val pairs, D, k):
FLOPs 2 U I D, f32 products on the CUDA cores (the contract is full f32,
so no tensor core), against the H100 SXM data sheet's 67e12 f32 FLOP/s,
held here since ``peaks.json`` holds the bf16 and HBM peaks only; bytes:
the two tables at 4 bytes ((U + I) D 4), seen once as the smaller of a
bitmap (U I / 8) and an edge list (8 nnz), and the lists written, int32
ids and f32 scores (U k 8). The least time is the larger of FLOPs over
that peak and bytes over the HBM peak. The device time of a launch is that
of ``retrieval.cu``'s ``fused_topk_kernel`` and ``common.cuh``'s
``part_lists_merge_kernel`` (the merge of the catalog parts) over the
window's launches; read only where the trace's ``fused_topk_kernel``
events equal the launch count. Kernel 4, whose split merge is the same
``part_lists_merge_kernel``, runs in no cell that reports this metric, so
every merge in such a window is kernel 2's."""

F32_FLOPS_PER_S = 67e12  # NVIDIA H100 SXM data sheet, FP32 outside the tensor cores

COUNTERS = {"fused_topk_retrieval":
            "lgcnhs_tpu_torch.ops.cuda.retrieval:fused_topk_retrieval.launches"}


def work(shapes):
    U, I, nnz, D, k = shapes["U"], shapes["I"], shapes["nnz"], shapes["D"], shapes["k"]
    seen = min(U * I / 8.0, 8.0 * nnz)
    return 2.0 * U * I * D, (U + I) * D * 4.0 + seen + U * k * 8.0


def least_seconds(shapes, peaks) -> float:
    flops, nbytes = work(shapes)
    return max(flops / F32_FLOPS_PER_S, nbytes / peaks["hbm_bytes_per_s"])


def read(ctx):
    launches = ctx.counts.get("fused_topk_retrieval", 0)
    mains = ctx.view.kernels_named("fused_topk_kernel")
    if launches == 0 or len(mains) != launches:
        return None
    ops = ctx.view.kernels_named("fused_topk_kernel", "part_lists_merge_kernel")
    per_launch = sum(e - s for _, s, e in ops) / 1e9 / launches
    return 100.0 * least_seconds(ctx.shapes, ctx.peaks) / per_launch

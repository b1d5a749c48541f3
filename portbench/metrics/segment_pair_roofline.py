"""``segment_pair_roofline``: the least time one ``segment_pair`` launch
(one LightGCN layer over the edge list, both directions) needs, over its
device time, in %.

Its work, from shapes alone (U users, I items, nnz train edges, D), for the
pair whatever the kernel fuses into it: it reads the graph once as an edge
list (8 nnz bytes) and both f32 tables ((U + I) D 4 bytes), and writes the
two f32 products ((U + I) D 4 bytes); FLOPs 4 nnz D (a multiply and an add
per edge and column, both directions). The least time is the larger of
bytes over the HBM peak and FLOPs over the bf16 peak (bytes, by far). The
device time of a launch is that of its kernels, ``segment_pair_kernel`` and
the chunk sum ``segment_pair_reduce_kernel``, over the window's launches;
read only where the trace's ``segment_pair_kernel`` events equal the
wrapper's launch count (``lgcnhs_tpu_torch/ops/cuda/segment_propagation``).
A program without that module gets no ``COUNTERS`` here, and the metric
reads nothing."""
import importlib.util

PROGRAM = "lgcnhs_tpu_torch.ops.cuda.segment_propagation"
COUNTERS = ({"segment_pair": f"{PROGRAM}:segment_pair.launches"}
            if importlib.util.find_spec(PROGRAM) is not None else {})


def work(shapes):
    U, I, nnz, D = shapes["U"], shapes["I"], shapes["nnz"], shapes["D"]
    return 4.0 * nnz * D, 8.0 * nnz + (U + I) * D * 4.0 + (U + I) * D * 4.0


def least_seconds(shapes, peaks) -> float:
    flops, nbytes = work(shapes)
    return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])


def read(ctx):
    launches = ctx.counts.get("segment_pair", 0)
    mains = ctx.view.kernels_named("segment_pair_kernel")
    if launches == 0 or len(mains) != launches:
        return None
    ops = ctx.view.kernels_named("segment_pair_kernel", "segment_pair_reduce_kernel")
    per_launch = sum(e - s for _, s, e in ops) / 1e9 / launches
    return 100.0 * least_seconds(ctx.shapes, ctx.peaks) / per_launch

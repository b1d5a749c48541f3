"""``serve.host_share``: of the traced passes' wall time, the share before
each pass's first kernel starts on the card, in %: the host's numpy build
of A and seen and their upload (copies are not kernels)."""


def read(ctx):
    before = total = 0
    for start, end, _ in ctx.view.within(ctx.records.get("passes", [])):
        first = ctx.view.first_kernel_after(start, end)
        if first is None:
            return None
        before += first - start
        total += end - start
    return 100.0 * before / total if total else None

"""``train.eval_share``: of the traced window's intervals that end in an
evaluation record, the share of their wall time that comes after the
interval's last CUDA graph replay has finished on the card, in %. That
time is the trainer's val loss and ``evaluate()`` (and the record itself).
The end of the replays is a CUDA event the train driver records behind
each replay, placed on the host's clock from an event recorded at the
window's opening on an idle card: a host-clock reading of the driver's
own, until the program has spans there."""


def read(ctx):
    spans = [iv for iv in ctx.view.within(ctx.records.get("intervals", []), lambda r: r.end_ns)
             if iv.kind == "eval" and iv.replay_end_ns is not None]
    if not spans:
        return None
    total = sum(iv.end_ns - iv.start_ns for iv in spans)
    after = sum(max(0, iv.end_ns - iv.replay_end_ns) for iv in spans)
    return 100.0 * after / total

"""``train.eval_idle_share``: the share of the traced training window, in
%, in which no operation runs on the card while the host is inside the
program's ``train.val_loss`` or ``train.evaluate`` span
(``spans.idle_share_inside``): the evaluation's own host work. Not
``train.record``: there the host waits at the row's first read for the
interval's queued work, and the card's gaps are the replayed graph's.
None where the program opens no such span."""
from portbench import spans


def read(ctx):
    return spans.idle_share_inside(ctx.view, "train.val_loss", "train.evaluate")

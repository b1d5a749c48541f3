"""``train.launch_idle_share``: the share of the traced training window, in
%, in which no operation runs on the card while the host is inside the
program's ``train.replay`` span: the re-seeds, the lr copy, the CUDA graph's
launch and the launch counts of one replay (``spans.idle_share_inside``).
None where the program opens no such span."""
from portbench import spans


def read(ctx):
    return spans.idle_share_inside(ctx.view, "train.replay")

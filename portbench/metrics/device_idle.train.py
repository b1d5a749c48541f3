"""``device_idle.train``: the share of the traced training window in which
no operation runs on the card (kernels, copies, sets), in %."""


def read(ctx):
    return ctx.view.idle_percent()

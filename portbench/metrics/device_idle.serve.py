"""``device_idle.serve``: the share of the traced serving window (its
passes, back to back) in which no operation runs on the card, in %."""


def read(ctx):
    return ctx.view.idle_percent()

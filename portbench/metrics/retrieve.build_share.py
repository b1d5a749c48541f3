"""``retrieve.build_share``: over the program's ``retrieve.pass`` spans that
end in the traced window, the time inside their ``retrieve.build`` and
``retrieve.upload`` spans (the host's edge array, seen set on the card
from it, and the edge array's copy) over the time inside them, in %
(``spans.share_of_outer``). None where the program opens no such span."""
from portbench import spans


def read(ctx):
    build = spans.share_of_outer(ctx.view, "retrieve.pass", "retrieve.build")
    if build is None:
        return None
    return build + spans.share_of_outer(ctx.view, "retrieve.pass", "retrieve.upload")

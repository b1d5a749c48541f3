"""``serve.build_share``: over the program's ``serve.pass`` spans that end
in the traced window, the time inside their ``serve.build`` spans (the
host's numpy build of A and seen) over the time inside them, in %
(``spans.share_of_outer``). None where the program opens no such span."""
from portbench import spans


def read(ctx):
    return spans.share_of_outer(ctx.view, "serve.pass", "serve.build")

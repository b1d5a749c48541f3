"""``serve.upload_share``: over the program's ``serve.pass`` spans that end
in the traced window, the time inside their ``serve.upload`` spans (A and
seen copied to the card from pageable host memory) over the time inside
them, in % (``spans.share_of_outer``). None where the program opens no
such span."""
from portbench import spans


def read(ctx):
    return spans.share_of_outer(ctx.view, "serve.pass", "serve.upload")

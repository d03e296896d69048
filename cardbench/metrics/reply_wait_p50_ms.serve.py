"""Median ms from the end of a window request's ``serve.pass`` to the end of
its ``serve.reply``: the packaging of the replies ahead of it in its group,
then its own (``cardbench/spans.py``)."""

from cardbench import spans


def read(ctx):
    return spans.metric(ctx, "reply_wait_p50_ms")

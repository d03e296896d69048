"""Median ms of a window request's ``serve.queued`` span, from its enqueue to
the closing of the group that takes it: the wait behind the passes and the
packaging ahead of it, and its group's coalescing (``cardbench/spans.py``)."""

from cardbench import spans


def read(ctx):
    return spans.metric(ctx, "dispatch_wait_p50_ms")

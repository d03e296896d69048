"""Median ms of a window request's ``serve.encode`` span: ``RequestQueue.submit``
validating its chords and encoding them on the request's thread, the pull of
the conditions to the host included (``cardbench/spans.py``)."""

from cardbench import spans


def read(ctx):
    return spans.metric(ctx, "encode_ms_p50")

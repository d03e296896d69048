"""Median ms of a pass (``InferenceSession.predict`` -> ``ddim_paint`` at
the padded batch, with the pull of its result to the host), as each reply's
``device_ms`` reports it: a host clock around the whole pass."""

import statistics


def read(ctx):
    ms = ctx.get("pass_ms")
    return statistics.median(ms) if ms else None

"""Median ms a served request spends outside its pass (``serve.py``'s
``RequestQueue``: coalescing, waiting for the worker, packaging): its
latency less the reply's pass time."""

import statistics


def read(ctx):
    waits = ctx.get("queue_wait_ms")
    return statistics.median(waits) if waits else None

"""Samples a pass of the ``GenerationWorker`` served, of its padded batch:
the window's served samples over its passes, a pass counted once from its
replies' ``batched_with``."""


def read(ctx):
    passes = ctx.get("passes")
    return ctx["samples"] / passes if passes else None

"""Attentions a UNet evaluation that the program's dispatch ran as its plain
version (``ops.attention.plain_calls`` over the window, per evaluation). It
reads 70 while the cross-attentions take the plain version and every
self-attention takes kernel 1; a self-attention that misses kernel 1 raises
it. Nothing to read where the program keeps no such counter."""


def read(ctx):
    plain = ctx.get("counters", {}).get("ops.attention.plain_calls")
    if plain is None or not ctx.get("evals"):
        return None
    return plain / ctx["evals"]

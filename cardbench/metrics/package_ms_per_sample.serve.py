"""Host ms the worker spends packaging a sample of its replies (the
integrity score and the MIDI file of each caller's rows, on the dispatcher
thread before it takes the next pass), over the traced slice's replies: a
pass of n samples waits n times this before the next pass starts."""


def read(ctx):
    if ctx.get("trace") is None or not ctx.get("package_samples"):
        return None
    return 1000.0 * ctx["package_s"] / ctx["package_samples"]

"""The training step's share of the card's peak, in %: 3 x the reference's
forward FLOPs per sample x the window's samples over the window's seconds,
against the configuration's precision."""

from cardbench import readers


def read(ctx):
    spec = ctx["spec"]
    flops = 3 * readers.forward_flops(spec, 1) * ctx["batch"] * ctx["steps"]
    return 100.0 * flops / ctx["seconds"] / readers.peak_flops(spec)

"""The SDXL sampling loop's share of the card's peak, in %: the reference's
FLOPs per UNet evaluation at the CFG batch x the window's evaluations over
the window's seconds, against the configuration's precision (bf16, 989
TFLOP/s)."""

from cardbench import readers


def read(ctx):
    spec = ctx["spec"]
    flops = readers.forward_flops(spec, ctx["eval_batch"]) * ctx["evals"]
    return 100.0 * flops / ctx["seconds"] / readers.peak_flops(spec)

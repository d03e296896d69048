"""Kernel 1 (``ops/csrc/packed_attention.cu``) in the SDXL cell: its least
time over its device time in the profiled request, in %; one launch a
self-attention of the UNet (70 an evaluation: 4 and 20 in the input levels,
10 in the middle block, 30 and 6 in the output levels), each evaluation's
sites and their heads from the reference."""

from cardbench import readers
from cardbench.yardstick import attention_bound


def read(ctx):
    spec = ctx["spec"]
    att = readers.sites(spec, ctx["eval_batch"]).attention
    kind, size = readers.PRECISION_PEAK[spec.config["precision"]], readers.itemsize(spec)
    bound = sum(attention_bound(b, t, h, d, kind, size) for b, t, h, d in att)
    return readers.roofline(ctx, "attention_fwd", bound, len(att))

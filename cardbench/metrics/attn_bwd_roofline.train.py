"""Kernel 2 (``ops/csrc/packed_attention_bwd.cu``): its least time over its
device time in the profiled steps, in %; a backward a self-attention of the
UNet, each step's sites from the reference."""

from cardbench import readers
from cardbench.yardstick import attention_bwd_bound


def read(ctx):
    spec = ctx["spec"]
    att = readers.sites(spec, ctx["batch"]).attention
    kind, size = readers.PRECISION_PEAK[spec.config["precision"]], readers.itemsize(spec)
    bound = sum(attention_bwd_bound(b, t, h, d, kind, size) for b, t, h, d in att)
    return readers.roofline(ctx, "attention_bwd", bound)

"""Kernel 1 (``ops/csrc/packed_attention.cu``): its least time over its
device time in the profiled request, in %; one launch a self-attention of
the UNet, each evaluation's sites from the reference."""

from cardbench import readers
from cardbench.yardstick import attention_bound


def read(ctx):
    spec = ctx["spec"]
    att = readers.sites(spec, ctx["eval_batch"]).attention
    kind, size = readers.PRECISION_PEAK[spec.config["precision"]], readers.itemsize(spec)
    bound = sum(attention_bound(b, t, h, d, kind, size) for b, t, h, d in att)
    return readers.roofline(ctx, "attention_fwd", bound, len(att))

"""Kernel 6 (``ops/csrc/gn_bwd.cu``): its least time over its device time in
the profiled steps, in %; one launch a GroupNorm of the UNet, each step's
sites from the reference."""

from cardbench import readers
from cardbench.yardstick import gn_bwd_bound


def read(ctx):
    spec = ctx["spec"]
    gn = readers.sites(spec, ctx["batch"]).group_norm
    bound = sum(gn_bwd_bound(shape, readers.itemsize(spec)) for shape in gn)
    return readers.roofline(ctx, "gn_bwd", bound, len(gn))

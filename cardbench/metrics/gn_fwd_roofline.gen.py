"""Kernel 8 (``ops/csrc/gn_fwd.cu``): its least time over its device time in
the profiled request, in %; one launch a GroupNorm of the UNet, each
evaluation's sites from the reference. The least time of a site: x read and
y written once at the card's HBM rate."""

from cardbench import readers
from cardbench.yardstick import HBM_BYTES_PER_S


def gn_fwd_bound(shape, itemsize):
    """ms: x read once and y written once."""
    numel = 1
    for s in shape:
        numel *= s
    return 2 * numel * itemsize / HBM_BYTES_PER_S * 1e3


def read(ctx):
    spec = ctx["spec"]
    gn = readers.sites(spec, ctx["eval_batch"]).group_norm
    bound = sum(gn_fwd_bound(shape, readers.itemsize(spec)) for shape in gn)
    return readers.roofline(ctx, "gn_fwd", bound, len(gn))

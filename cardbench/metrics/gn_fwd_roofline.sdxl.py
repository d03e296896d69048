"""Kernel 8 (``ops/csrc/gn_fwd.cu``) in the SDXL cell: its least time over
its device time in the profiled request, in %. One launch a GroupNorm site
of the reference: 46 an evaluation (the two 2560-channel inputs of the
decoder's first two level-2 ResBlocks, 80 channels a group, among them), and
none of a group wider than the kernel's table, should a configuration have
one. The least time of a site: x read and y written once at the card's HBM
rate."""

from cardbench import readers
from cardbench.yardstick import HBM_BYTES_PER_S

GROUPS = 32
MAX_CHANNELS_PER_GROUP = 128  # gn_fwd.cu's kMaxChannels, NCHW


def gn_fwd_bound(shape, itemsize):
    """ms: x read once and y written once."""
    numel = 1
    for s in shape:
        numel *= s
    return 2 * numel * itemsize / HBM_BYTES_PER_S * 1e3


def taken(group_norms):
    return [s for s in group_norms if s[1] // GROUPS <= MAX_CHANNELS_PER_GROUP]


def read(ctx):
    spec = ctx["spec"]
    gn = taken(readers.sites(spec, ctx["eval_batch"]).group_norm)
    bound = sum(gn_fwd_bound(shape, readers.itemsize(spec)) for shape in gn)
    return readers.roofline(ctx, "gn_fwd", bound, len(gn))

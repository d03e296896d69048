"""Device ms per UNet evaluation of the SDXL cell: the profiled request's
device busy time over its evaluations."""

from cardbench.yardstick import busy_us


def read(ctx):
    trace = ctx.get("trace")
    if trace is None or not trace.device:
        return None
    return busy_us(trace.device) / 1e3 / trace.units

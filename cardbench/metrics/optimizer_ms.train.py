"""Device ms per step of the foreach kernels (``train/step.py`` and
``train/state.py``: the clip's scaling, Adam, the bf16 refresh) in the
profiled steps. The per-leaf gradient casts onto the masters are
elementwise copies and fall outside this class."""

from cardbench.yardstick import kernel_us


def read(ctx):
    trace = ctx.get("trace")
    if trace is None:
        return None
    us, n = kernel_us(trace, "multi_tensor")
    return us / 1e3 / trace.units if n else None

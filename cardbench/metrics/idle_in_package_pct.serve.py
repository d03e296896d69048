"""% of the card's idle time in the traced slice during which the dispatcher
thread was inside ``serve.package``: the program's spans laid on the slice's
device timeline by the estimated offset of the two clocks
(``cardbench/spans.py``)."""

from cardbench import spans


def read(ctx):
    return spans.metric(ctx, "idle_in_package_pct")

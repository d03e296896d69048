"""% of the card's idle time in the traced slice during which a ``serve.pass``
was open on the dispatcher thread: the host's launches leaving the card
waiting inside a pass (``cardbench/spans.py``)."""

from cardbench import spans


def read(ctx):
    return spans.metric(ctx, "idle_in_pass_pct")

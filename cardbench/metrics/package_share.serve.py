"""% of the window's time, from its first request's enqueue to its last
reply, that the dispatcher thread spent inside ``serve.package`` (the
integrity score and MIDI file of each reply), unprofiled
(``cardbench/spans.py``)."""

from cardbench import spans


def read(ctx):
    return spans.metric(ctx, "package_share")

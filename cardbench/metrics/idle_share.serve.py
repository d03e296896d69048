"""The card's idle share while it serves the window's arrivals, in %
(``readers.idle_share``): busy time a pass times the passes over the time
from the first arrival to the last reply."""

from cardbench import readers


def read(ctx):
    return readers.idle_share(ctx)

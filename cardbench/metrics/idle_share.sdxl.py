"""The card's idle share over the SDXL cell's window, in %
(``readers.idle_share``)."""

from cardbench import readers


def read(ctx):
    return readers.idle_share(ctx)

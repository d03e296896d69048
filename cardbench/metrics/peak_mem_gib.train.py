"""The card's peak allocated memory over the window, GiB
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)."""


def read(ctx):
    peak = ctx.get("window_peak_bytes")
    return None if peak is None else peak / 2 ** 30

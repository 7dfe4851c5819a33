"""GiB of the card's memory at the window's peak:
``torch.cuda.max_memory_allocated()`` after ``reset_peak_memory_stats()`` at
the window's start, weights included."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30

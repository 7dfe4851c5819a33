"""Seconds from the process's start to the first timed unit: imports, the
weights made on the card, the program's layout transforms, loading (and,
in a fresh checkout, building) its kernels, and the warm-up."""


def read(ctx):
    return ctx["setup_s"]

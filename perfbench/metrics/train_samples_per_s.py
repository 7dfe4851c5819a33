"""Training samples per second of the window: the rows of every QLoRA step,
over the seconds from the window's start to the end of the first step that
completes after ``--seconds`` (host clock; each step ends in a
synchronize)."""


def read(ctx):
    w = ctx["window"]
    return w["work"] / w["seconds"]

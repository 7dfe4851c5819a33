"""Images completed per second of the window: every image of every
request, over the seconds from the window's start to the end of the first
request that completes after ``--seconds`` (host clock; each request ends
with its images on the host)."""


def read(ctx):
    w = ctx["window"]
    return w["work"] / w["seconds"]

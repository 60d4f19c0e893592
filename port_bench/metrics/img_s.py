"""Images whose labels reached the host in the window, over the window's
seconds (host clock)."""


def read(ctx):
    w = ctx["window"]
    return w["images"] / w["seconds"] if w["seconds"] > 0 else None

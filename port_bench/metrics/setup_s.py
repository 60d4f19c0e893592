"""Process start to the window's start: imports, the kernels' load or
build, weights, the traffic pool and the warm-up (host clock)."""


def read(ctx):
    return ctx["window"]["setup_s"]

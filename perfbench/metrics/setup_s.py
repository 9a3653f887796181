"""``setup_s``: seconds from the process's start to the start of the first
timed request: imports, CUDA, the kernel build or its cache, the inputs
made from the seed, the warm-up request (host clock)."""


def read(ctx):
    return ctx.setup_s

"""``launches_per_frame``: kernel launches counted by the ``launches``
counters of the program's ``ops/cuda_*.py`` wrappers over the window, per
frame scored."""


def read(ctx):
    if ctx.launches is None or ctx.frames <= 0:
        return None
    return sum(ctx.launches.values()) / ctx.frames

"""``kernel_roofline_pct``: the least time of every stage the window ran
(``perfbench/stages``, counted from the algorithm for the frames scored),
over the device time of the kernels that implement those stages."""


def read(ctx):
    least = busy = 0.0
    for name in ctx.stages:
        s = ctx.stage_share(name)
        if s is not None:
            least += s[0]
            busy += s[1]
    return 100.0 * least / busy if busy > 0 else None

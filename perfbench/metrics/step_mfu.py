"""``step_mfu``: the share of the card's peak that the whole step used:
frames scored in the traced window times the least time of one frame,
over the window's seconds. A frame's least time is the larger of its bytes
(the reference and distorted planes read once at their stored size, the
scores written once) over the memory rate and the operations of every
stage over the scalar rate."""


def read(ctx):
    if ctx.trace is None or ctx.window_s <= 0 or not ctx.stages:
        return None
    cfg = ctx.cfg
    depth = int(cfg["bit_depth"])
    h, w = int(cfg["height"]), int(cfg["width"])
    stored = 1 if depth == 8 else 2
    px = h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)
    nbytes = 2 * px * stored + 32 * 8
    ops = sum(st.work(cfg)[1] for st in ctx.stages.values())
    return 100.0 * ctx.frames * ctx.peaks.least_seconds(nbytes, ops) / ctx.window_s

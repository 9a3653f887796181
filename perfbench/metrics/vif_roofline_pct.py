"""``vif_roofline_pct``: the integer VIF stage's least time for the frames
scored in the window, over the device time of its kernels."""


def read(ctx):
    s = ctx.stage_share("vif_int")
    return 100.0 * s[0] / s[1] if s is not None else None

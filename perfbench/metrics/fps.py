"""``fps``: frames scored (VMAF, PSNR and SSIM) in the window's whole
requests that returned a result, over the window's seconds (host clock)."""


def read(ctx):
    return ctx.frames / ctx.window_s if ctx.window_s > 0 else None

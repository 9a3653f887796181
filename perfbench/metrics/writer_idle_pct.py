"""``writer_idle_pct``: the share of the traced window in which the card was
idle while the host's innermost event was one of the program's
``app.write_*`` spans (the libvmaf JSON log and the PSNR and SSIM logs);
0 where the trace names gaps by program spans but none by these. None
where it names no gap by a program span (a program without spans)."""

PROGRAM = ("app.", "scoring.", "features.", "streaming.")


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0 or not any(n.startswith(PROGRAM) for n in t.idle_s):
        return None
    return 100.0 * sum(s for n, s in t.idle_s.items() if n.startswith("app.write_")) / t.window_s

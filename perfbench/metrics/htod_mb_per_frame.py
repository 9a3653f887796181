"""``htod_mb_per_frame``: megabytes of frame planes copied to the card in the
traced window, per frame scored: the ``htod_bytes`` counts of the program's
``scoring.upload.copy`` spans (``pqa2_tpu_torch.utils.profiling``), which
record only while the window's profiler runs. None where the program keeps
no span records."""


def read(ctx):
    try:
        from pqa2_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    recs = records()
    if not recs or ctx.frames <= 0:
        return None
    return sum(r.counts.get("htod_bytes", 0) for r in recs) / ctx.frames / 1e6

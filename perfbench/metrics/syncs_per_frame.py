"""``syncs_per_frame``: blocking device-to-host reads in the traced window,
per frame scored: the ``syncs`` counts of the program's ``scoring.sync``
spans (``pqa2_tpu_torch.utils.profiling``), which record only while the
window's profiler runs. None where the program keeps no span records."""


def read(ctx):
    try:
        from pqa2_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    recs = records()
    if not recs or ctx.frames <= 0:
        return None
    return sum(r.counts.get("syncs", 0) for r in recs) / ctx.frames

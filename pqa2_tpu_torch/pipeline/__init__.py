"""Feature extraction, streaming clip scoring and libvmaf-schema JSON.

frames -> features (VIF x4, ADM2, motion2) -> nu-SVR fusion -> per-frame
scores + pooled metrics on the caller's device. The names of
``pqa2_tpu/pipeline/__init__.py`` are exported lazily: importing a
submodule (``pipeline.streaming``, ``pipeline.batch``) does not import
the others.
"""

_EXPORTS = {
    "extract_features_batched": "features",
    "ClipScores": "scoring",
    "score_clip": "scoring",
    "score_planes": "scoring",
    "clip_scores_to_json": "json_out",
    "write_vmaf_json": "json_out",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

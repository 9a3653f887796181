# Copy of pqa2_tpu/models/registry.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Built-in model registry.

The framework ships the standard Netflix VMAF models preparsed to dense .npz
arrays (see tools/convert_vmaf_model.py). Names mirror libvmaf's
``model=version=...`` identifiers, which is also what the reference app passes
around (app/vmaf_analyzer.py:373-380 builds ``model=version={model}``; the UI
discovers names by scanning models/*.json, app/ui/tabs/analysis_tab.py:1005).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional

from pqa2_tpu_torch.models.loader import load_model, load_model_npz

_DATA_DIR = os.path.join(os.path.dirname(__file__), "data")

DEFAULT_MODEL = "vmaf_v0.6.1"

# Process-wide user model directory (the reference's "VMAF models directory"
# setting, app/ui/tabs/options_tab.py paths category). Set from
# settings by the app/CLI via set_user_models_dir(); PQA2_MODELS_DIR is the
# env-var override for headless use.
_USER_MODELS_DIR: Optional[str] = None


def set_user_models_dir(path: Optional[str]) -> None:
    """Point the registry at a directory of user-supplied libvmaf model
    JSONs; '' / None clears it. Applied wherever callers don't pass an
    explicit extra_dir."""
    global _USER_MODELS_DIR
    _USER_MODELS_DIR = path or None


def get_user_models_dir() -> Optional[str]:
    return _USER_MODELS_DIR or os.environ.get("PQA2_MODELS_DIR") or None


def _resolve_extra(extra_dir: Optional[str]) -> Optional[str]:
    return extra_dir if extra_dir is not None else get_user_models_dir()


def available_models(extra_dir: Optional[str] = None) -> List[str]:
    """Names of all packaged models (without extension), plus any user
    model JSONs found in `extra_dir` (the reference's models/-directory
    scan, app/ui/tabs/analysis_tab.py:1005-1077)."""
    extra_dir = _resolve_extra(extra_dir)
    names = set()
    if os.path.isdir(_DATA_DIR):
        names.update(
            f[: -len(".npz")] for f in os.listdir(_DATA_DIR)
            if f.endswith(".npz")
        )
    if extra_dir and os.path.isdir(extra_dir):
        names.update(
            f[: -len(".json")] for f in os.listdir(extra_dir)
            if f.endswith(".json")
        )
    return sorted(names)


def get_model(name: str = DEFAULT_MODEL, extra_dir: Optional[str] = None):
    """Load a model by registry name, or by path to a libvmaf .json/.npz file.

    extra_dir: user model directory searched after the packaged registry;
    defaults to the configured user models dir (set_user_models_dir)."""
    return _get_model_cached(name, _resolve_extra(extra_dir))


@functools.lru_cache(maxsize=None)
def _get_model_cached(name: str, extra_dir: Optional[str]):
    if os.path.sep in name or name.endswith((".json", ".npz")):
        if name.endswith(".npz"):
            return load_model_npz(name)
        return load_model(name)
    path = os.path.join(_DATA_DIR, f"{name}.npz")
    if os.path.exists(path):
        return load_model_npz(path, name=name)
    if extra_dir:
        user_path = os.path.join(extra_dir, f"{name}.json")
        if os.path.exists(user_path):
            return load_model(user_path, name=name)
    raise KeyError(
        f"unknown model {name!r}; available: {available_models(extra_dir)}"
    )

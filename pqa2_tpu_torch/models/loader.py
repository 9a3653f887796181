# Copy of pqa2_tpu/models/loader.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""VMAF model loading.

Parses Netflix libvmaf model files (the ``models/*.json`` set shipped with the
reference app and consumed there via ffmpeg's ``model=path=...`` option,
reference: app/vmaf_analyzer.py:372-408) into dense numpy arrays ready for the
JAX score-fusion path:

* ``model_dict.feature_names``   -> canonical feature keys (adm2, motion2,
                                    vif_scale0..3)
* ``model_dict.slopes/intercepts`` -> linear_rescale normalisation (index 0 is
                                    the score axis, 1..n the features)
* ``model_dict.model``           -> embedded libsvm nu-SVR text block:
                                    support-vector coefficients, sparse
                                    feature values, kernel gamma, rho
* ``score_transform``            -> polynomial p0 + p1*s + p2*s^2 with
                                    optional out_gte_in monotonic clamp
* ``feature_opts_dicts``         -> NEG-model enhancement-gain limits
                                    (adm_enhn_gain_limit / vif_enhn_gain_limit)
* bootstrap files (vmaf_b_*)     -> a stack of 21 sub-models -> mean score +
                                    confidence interval

Models can be loaded either from a raw libvmaf JSON file (``load_model(path)``)
or from this package's preparsed ``.npz`` registry (see registry.py).
"""

from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence

import numpy as np

# Canonical feature order used throughout the framework. Matches the order in
# which every shipped model lists its features (model_dict.feature_names).
CANONICAL_FEATURES = (
    "adm2",
    "motion2",
    "vif_scale0",
    "vif_scale1",
    "vif_scale2",
    "vif_scale3",
)

_FEATURE_NAME_RE = re.compile(
    r"^VMAF_(?:integer_)?feature_(?P<key>[a-z0-9_]+?)(?:_score)?$"
)


def canonical_feature_key(name: str) -> str:
    """'VMAF_integer_feature_adm2_score' -> 'adm2' (also accepts bare keys)."""
    m = _FEATURE_NAME_RE.match(name)
    if m:
        return m.group("key")
    return name


@dataclasses.dataclass(frozen=True)
class ScoreTransform:
    p0: float
    p1: float
    p2: float
    out_gte_in: bool

    def apply(self, s):
        y = self.p0 + self.p1 * s + self.p2 * s * s
        if self.out_gte_in:
            y = np.maximum(y, s) if isinstance(y, np.ndarray) else max(y, s)
        return y


@dataclasses.dataclass(frozen=True)
class VMAFModel:
    """A single nu-SVR VMAF model in dense-array form."""

    name: str
    feature_names: tuple  # canonical keys, length F
    slopes: np.ndarray  # (F+1,) float64; [0] is the score axis
    intercepts: np.ndarray  # (F+1,) float64
    sv_coef: np.ndarray  # (n_sv,) float64 — dual coefficients (alpha)
    sv: np.ndarray  # (n_sv, F) float64 — support vectors
    gamma: float  # RBF kernel gamma
    rho: float  # libsvm bias; decision = sum(coef*K) - rho
    score_clip: Optional[tuple]  # (lo, hi) or None
    score_transform: Optional[ScoreTransform]
    feature_opts: tuple  # per-feature dict of extractor options (NEG limits)
    uses_integer_features: bool  # True if trained on integer_* feature names

    @property
    def n_features(self) -> int:
        return len(self.feature_names)

    @property
    def n_sv(self) -> int:
        return int(self.sv.shape[0])

    def feature_opt(self, feature: str, key: str, default):
        """Per-feature extractor option, e.g. vif_enhn_gain_limit for NEG."""
        try:
            idx = self.feature_names.index(feature)
        except ValueError:
            return default
        return self.feature_opts[idx].get(key, default)


@dataclasses.dataclass(frozen=True)
class BootstrapModel:
    """A BOOTSTRAP_LIBSVMNUSVR ensemble (e.g. vmaf_b_v0.6.3): sub-model 0 is
    the primary predictor; 1..n provide the bootstrap confidence interval."""

    name: str
    models: tuple  # tuple[VMAFModel]

    @property
    def n_models(self) -> int:
        return len(self.models)

    @property
    def feature_names(self) -> tuple:
        return self.models[0].feature_names


def _parse_libsvm_text(text: str):
    """Parse an embedded libsvm nu_svr model block.

    Header lines (svm_type/kernel_type/gamma/rho/total_sv/...) followed by
    'SV' and one line per support vector: '<coef> i:v i:v ...' with 1-based
    sparse feature indices.
    """
    header: Dict[str, str] = {}
    lines = text.strip().splitlines()
    sv_start = None
    for i, line in enumerate(lines):
        line = line.strip()
        if line == "SV":
            sv_start = i + 1
            break
        parts = line.split(None, 1)
        if len(parts) == 2:
            header[parts[0]] = parts[1]
        elif len(parts) == 1:
            header[parts[0]] = ""
    if sv_start is None:
        raise ValueError("libsvm model block has no SV section")
    if header.get("svm_type") != "nu_svr":
        raise ValueError(f"unsupported svm_type {header.get('svm_type')!r}")
    if header.get("kernel_type") != "rbf":
        raise ValueError(f"unsupported kernel_type {header.get('kernel_type')!r}")

    gamma = float(header["gamma"])
    rho = float(header["rho"])
    total_sv = int(header["total_sv"])

    coefs: List[float] = []
    rows: List[Dict[int, float]] = []
    max_idx = 0
    for line in lines[sv_start:]:
        line = line.strip()
        if not line:
            continue
        toks = line.split()
        coefs.append(float(toks[0]))
        row: Dict[int, float] = {}
        for tok in toks[1:]:
            idx_s, val_s = tok.split(":")
            idx = int(idx_s)
            row[idx] = float(val_s)
            max_idx = max(max_idx, idx)
        rows.append(row)
    if len(rows) != total_sv:
        raise ValueError(f"expected {total_sv} SVs, parsed {len(rows)}")

    sv = np.zeros((total_sv, max_idx), dtype=np.float64)
    for r, row in enumerate(rows):
        for idx, val in row.items():
            sv[r, idx - 1] = val
    return np.asarray(coefs, dtype=np.float64), sv, gamma, rho


def _parse_score_transform(d) -> Optional[ScoreTransform]:
    if not d:
        return None
    return ScoreTransform(
        p0=float(d.get("p0", 0.0)),
        p1=float(d.get("p1", 1.0)),
        p2=float(d.get("p2", 0.0)),
        out_gte_in=str(d.get("out_gte_in", "false")).lower() == "true",
    )


def _model_from_dicts(name: str, model_dict: dict) -> VMAFModel:
    raw_names = model_dict["feature_names"]
    feature_names = tuple(canonical_feature_key(n) for n in raw_names)
    uses_integer = any("integer" in n for n in raw_names)

    slopes = np.asarray(model_dict["slopes"], dtype=np.float64)
    intercepts = np.asarray(model_dict["intercepts"], dtype=np.float64)
    if model_dict.get("norm_type") != "linear_rescale":
        raise ValueError(f"unsupported norm_type {model_dict.get('norm_type')!r}")

    coef, sv, gamma, rho = _parse_libsvm_text(model_dict["model"])
    if sv.shape[1] != len(feature_names):
        # Pad in case trailing features are entirely zero in every SV.
        padded = np.zeros((sv.shape[0], len(feature_names)), dtype=np.float64)
        padded[:, : sv.shape[1]] = sv
        sv = padded

    clip = model_dict.get("score_clip")
    opts_list = model_dict.get("feature_opts_dicts")
    if opts_list is None:
        opts_list = [{} for _ in feature_names]

    return VMAFModel(
        name=name,
        feature_names=feature_names,
        slopes=slopes,
        intercepts=intercepts,
        sv_coef=coef,
        sv=sv,
        gamma=gamma,
        rho=rho,
        score_clip=tuple(float(c) for c in clip) if clip else None,
        score_transform=_parse_score_transform(model_dict.get("score_transform")),
        feature_opts=tuple(dict(o) for o in opts_list),
        uses_integer_features=uses_integer,
    )


def parse_model_json(obj: dict, name: str = "model"):
    """Parse a loaded libvmaf model JSON object.

    Returns a VMAFModel, or a BootstrapModel for the vmaf_b_* layout where the
    top level is {"0": {...}, "1": {...}, ...} with BOOTSTRAP_LIBSVMNUSVR
    sub-models.
    """
    if "model_dict" in obj:
        mt = obj["model_dict"].get("model_type")
        if mt not in ("LIBSVMNUSVR", "BOOTSTRAP_LIBSVMNUSVR"):
            raise ValueError(f"unsupported model_type {mt!r}")
        return _model_from_dicts(name, obj["model_dict"])
    # Bootstrap layout: integer-keyed dict of sub-models.
    keys = sorted((k for k in obj.keys() if k.isdigit()), key=int)
    if not keys:
        raise ValueError("unrecognised model JSON layout")
    subs = tuple(
        _model_from_dicts(f"{name}.{k}", obj[k]["model_dict"]) for k in keys
    )
    return BootstrapModel(name=name, models=subs)


def load_model(path: str, name: Optional[str] = None):
    """Load a libvmaf JSON model file from disk."""
    with open(path) as f:
        obj = json.load(f)
    if name is None:
        name = re.sub(r"\.json$", "", path.split("/")[-1])
    return parse_model_json(obj, name=name)


# ---------------------------------------------------------------------------
# npz (de)serialisation — the packaged registry format


def model_to_npz_dict(model: VMAFModel, prefix: str = "") -> Dict[str, np.ndarray]:
    d = {
        f"{prefix}feature_names": np.asarray(model.feature_names),
        f"{prefix}slopes": model.slopes,
        f"{prefix}intercepts": model.intercepts,
        f"{prefix}sv_coef": model.sv_coef,
        f"{prefix}sv": model.sv,
        f"{prefix}gamma": np.float64(model.gamma),
        f"{prefix}rho": np.float64(model.rho),
        f"{prefix}uses_integer_features": np.bool_(model.uses_integer_features),
    }
    if model.score_clip is not None:
        d[f"{prefix}score_clip"] = np.asarray(model.score_clip)
    if model.score_transform is not None:
        st = model.score_transform
        d[f"{prefix}score_transform"] = np.asarray(
            [st.p0, st.p1, st.p2, 1.0 if st.out_gte_in else 0.0]
        )
    d[f"{prefix}feature_opts_json"] = np.asarray(json.dumps(list(model.feature_opts)))
    return d


def model_from_npz_dict(d, name: str, prefix: str = "") -> VMAFModel:
    def get(key):
        return d[f"{prefix}{key}"]

    st = None
    if f"{prefix}score_transform" in d:
        p = np.asarray(get("score_transform"), dtype=np.float64)
        st = ScoreTransform(float(p[0]), float(p[1]), float(p[2]), bool(p[3] > 0.5))
    clip = None
    if f"{prefix}score_clip" in d:
        clip = tuple(float(c) for c in np.asarray(get("score_clip")))
    opts = tuple(json.loads(str(get("feature_opts_json"))))
    return VMAFModel(
        name=name,
        feature_names=tuple(str(s) for s in get("feature_names")),
        slopes=np.asarray(get("slopes"), dtype=np.float64),
        intercepts=np.asarray(get("intercepts"), dtype=np.float64),
        sv_coef=np.asarray(get("sv_coef"), dtype=np.float64),
        sv=np.asarray(get("sv"), dtype=np.float64),
        gamma=float(get("gamma")),
        rho=float(get("rho")),
        score_clip=clip,
        score_transform=st,
        feature_opts=opts,
        uses_integer_features=bool(get("uses_integer_features")),
    )


def save_model_npz(model, path: str) -> None:
    if isinstance(model, BootstrapModel):
        d: Dict[str, np.ndarray] = {"n_models": np.int64(model.n_models)}
        for i, sub in enumerate(model.models):
            d.update(model_to_npz_dict(sub, prefix=f"m{i}."))
    else:
        d = model_to_npz_dict(model)
    np.savez_compressed(path, **d)


def load_model_npz(path: str, name: Optional[str] = None):
    if name is None:
        name = re.sub(r"\.npz$", "", str(path).split("/")[-1])
    with np.load(path, allow_pickle=False) as z:
        d = dict(z)
    if "n_models" in d:
        n = int(d["n_models"])
        subs = tuple(
            model_from_npz_dict(d, f"{name}.{i}", prefix=f"m{i}.") for i in range(n)
        )
        return BootstrapModel(name=name, models=subs)
    return model_from_npz_dict(d, name)

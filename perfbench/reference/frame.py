"""The plain reference of one scored frame: the integer VMAF features, the
SVR-fused VMAF, and PSNR and SSIM of each plane, in float64/uint64 NumPy.

It follows the frozen oracles in ``golden/`` (libvmaf's integer feature
extractors, ffmpeg's psnr and ssim filters) and reads the model's
coefficients from its own copy of the model file (``models/``). It imports
nothing of the program: the harness hands it the same code planes it
handed the program.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np

from perfbench.reference.golden.adm_int import adm_features_int
from perfbench.reference.golden.motion_int import blur_int
from perfbench.reference.golden.psnr import psnr_frame
from perfbench.reference.golden.ssim import ssim_frame
from perfbench.reference.golden.vif_int import vif_features_int

MODELS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "models")


def svr_vmaf(features: Dict[str, float], model_file: str) -> float:
    """libvmaf's prediction for one frame: linear rescale of each feature,
    RBF nu-SVR, inverse rescale, score transform, clip; all float64."""
    m = np.load(os.path.join(MODELS_DIR, model_file))
    names = [str(n) for n in m["feature_names"]]
    slopes, icpt = m["slopes"], m["intercepts"]
    x = np.array([features[n] for n in names], dtype=np.float64) * slopes[1:] + icpt[1:]
    d2 = np.sum((x[None, :] - m["sv"]) ** 2, axis=1)
    raw = float(np.sum(m["sv_coef"] * np.exp(-float(m["gamma"]) * d2)) - float(m["rho"]))
    score = (raw - icpt[0]) / slopes[0]
    if "score_transform" in m.files:
        p0, p1, p2, out_gte_in = (float(v) for v in m["score_transform"])
        y = p0 + p1 * score + p2 * score * score
        score = max(y, score) if out_gte_in else y
    if "score_clip" in m.files:
        lo, hi = (float(v) for v in m["score_clip"])
        score = min(max(score, lo), hi)
    return float(score)


def frame_reference(ref_y: Sequence[np.ndarray], t_in: int, dist: Dict[str, np.ndarray],
                    ref: Dict[str, np.ndarray], *, bit_depth: int, model_file: str,
                    vif_gain: Optional[float], adm_gain: float,
                    first: bool, last: bool) -> Dict[str, float]:
    """Reference values of one frame.

    ``ref_y``: the reference luma of the frame's neighbours as the clip has
    them (frame t-1 unless ``first``, t, t+1 unless ``last``), ``t_in`` the
    index of frame t in it; ``ref``/``dist``: the frame's {"y", "u", "v"}
    code planes. Motion is the SAD of the blurred reference against frame
    t-1 (0 at the clip's first frame), motion2 its minimum with the next
    SAD (the first frame's 0, the last frame's own motion)."""
    in_q = max(bit_depth - 8, 0)
    h, w = ref["y"].shape
    blurred = [blur_int(f, in_q).astype(np.int64) for f in ref_y]

    def sad(a, b):
        return float(np.abs(blurred[b] - blurred[a]).sum()) / (w * h * 256.0)

    motion = 0.0 if first else sad(t_in - 1, t_in)
    fwd = np.inf if last else sad(t_in, t_in + 1)
    motion2 = 0.0 if first else min(motion, fwd)
    vif = vif_features_int(ref["y"], dist["y"], np.inf if vif_gain is None else vif_gain,
                           bit_depth)
    adm2 = adm_features_int(ref["y"], dist["y"], adm_gain, bit_depth)[0]
    out = {"adm2": adm2, "motion": motion, "motion2": motion2,
           **{f"vif_scale{k}": v for k, v in enumerate(vif)}}
    out["vmaf"] = svr_vmaf(out, model_file)
    out.update(psnr_frame(ref, dist, max_value=(1 << bit_depth) - 1))
    out.update(ssim_frame(ref, dist, bit_depth=bit_depth))
    return out


def frame_reference_kw(kw: Dict) -> Dict[str, float]:
    """:func:`frame_reference` of a dict of arguments (a pool's task)."""
    return frame_reference(**kw)

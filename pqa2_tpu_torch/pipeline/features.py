"""Per-chunk feature extraction (port of pqa2_tpu/pipeline/features.py).

Two feature families, chosen by the model (:func:`resolve_precision`):

  * integer — every integer-trained model (the default ``vmaf_v0.6.1``
    among them): integer VIF over four scales with the motion SAD fused
    into scale 0 (``ops/cuda_vif_int.py``), integer ADM2 over four db2
    levels (``ops/cuda_adm_int.py``); ``precision="integer_fast"`` runs
    the same with VIF's smooth f32-log statistic in place of the LUT one;
  * float — the float-trained models (``vmaf_float_v0.6.1``, its NEG and
    4K variants, the bootstrap ``vmaf_float_b_v0.6.3``): f32 VIF over four
    scales with the ``classic`` statistic (``ops/cuda_vif.py``), whose
    scale-0 call also launches the motion SAD (``ops/cuda_motion.py``), and
    f32 ADM2 over four levels (``ops/cuda_adm.py``);

then motion/motion2 from the SADs. On CUDA tensors those run the
hand-written kernels, on CPU tensors their plain versions.

Halo contract (as the JAX package; trap 9): motion2 needs frames t-1 and
t+1, so a chunk that continues a clip carries one extra frame on each side
(``has_prev``/``has_next``); VIF and ADM run on the core frames only, the
motion SAD on every frame. A clip scored in chunks gives the same features
as the whole clip (tests/test_torch_slice.py).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from pqa2_tpu_torch.ops.cuda_adm import adm_features
from pqa2_tpu_torch.ops.cuda_adm_int import adm_features_int
from pqa2_tpu_torch.ops.cuda_vif import vif_features
from pqa2_tpu_torch.ops.cuda_vif_int import log2_table_audit, vif_motion_features_int
from pqa2_tpu_torch.ops.motion import features_from_sad_prev
from pqa2_tpu_torch.ops.motion_int import motion_from_sad
from pqa2_tpu_torch.utils.profiling import to_host

# "auto" follows the model's extractor family; "float"/"integer"/
# "integer_fast" force one (same environment override as pqa2_tpu).
FEATURE_PRECISION = os.environ.get("PQA2_FEATURE_PRECISION", "auto")


def resolve_precision(model, setting: Optional[str] = None) -> str:
    """'auto'|'float'|'integer'|'integer_fast' (+ model) -> concrete mode
    (pqa2_tpu/pipeline/features.py:41)."""
    p = setting or FEATURE_PRECISION
    if p == "auto":
        if hasattr(model, "models"):  # bootstrap stack
            model = model.models[0]
        return ("integer"
                if getattr(model, "uses_integer_features", False) else "float")
    if p not in ("float", "integer", "integer_fast"):
        raise ValueError(f"unknown feature precision {p!r}")
    return p


def model_feature_params(model, precision: Optional[str] = None, *,
                         device="cuda") -> Dict[str, object]:
    """Extraction knobs implied by a model's feature options
    (pqa2_tpu/pipeline/features.py:232).

    For ``"integer"`` this also audits the exact statistic's Q11 log2
    lookup on ``device`` (:func:`log2_table_audit`, 32768 mantissas),
    where the JAX package runs ``log2_direct_exceptions``; a passed audit
    is cached per device, so it runs for the first integer clip of a
    process, and a mismatch raises at every call.
    ``"integer_fast"`` reads no table, so it runs no audit (as the JAX
    package, pqa2_tpu/pipeline/features.py:251-258)."""
    if hasattr(model, "models"):  # BootstrapModel: sub-models share options
        model = model.models[0]
    out = {
        "vif_gain": float(model.feature_opt("vif_scale0", "vif_enhn_gain_limit",
                                            float("inf"))),
        "adm_gain": float(model.feature_opt("adm2", "adm_enhn_gain_limit", 100.0)),
        "vif_variant": "default" if model.uses_integer_features else "classic",
        "precision": resolve_precision(model, precision),
    }
    if out["precision"] == "integer":
        log2_table_audit(device)
    return out


def extract_features_batched(
    ref: torch.Tensor,
    dist: torch.Tensor,
    *,
    vif_gain: float = float("inf"),
    adm_gain: float = 100.0,
    vif_variant: str = "default",
    has_prev: bool = False,
    has_next: bool = False,
    precision: str = "float",
    bit_depth: int = 8,
) -> Dict[str, torch.Tensor]:
    """(N, H, W) luma pair (halo frames included) -> dict of (N_core,) f32
    features on the input's device: adm2, motion, motion2, vif_scale0..3.

    Luma is integer codes or f32 on the 8-bit scale; ``bit_depth`` lets
    the integer path recover the exact native codes (the float path is
    scale-invariant and casts to f32 on the device: the upload stays
    uint8)."""
    if precision not in ("integer", "integer_fast", "float"):
        raise ValueError(f"unknown feature precision {precision!r}")
    n, h, w = ref.shape
    core = slice(1 if has_prev else 0, n - 1 if has_next else n)
    if precision != "float":
        vif, sad = vif_motion_features_int(ref, dist, core=core, gain_limit=vif_gain,
                                           bit_depth=bit_depth,
                                           exact=precision == "integer")
        motion, motion2 = features_from_sad_prev(
            motion_from_sad(sad, h, w), n, has_prev=has_prev, has_next=has_next)
        adm2 = adm_features_int(ref[core], dist[core], gain_limit=adm_gain,
                                bit_depth=bit_depth)
    else:
        ref = ref.float()
        dist = dist.float()
        # VIF on the core frames; the motion SAD over every frame, halos
        # included, from the scale-0 call.
        vif, sad = vif_features(ref[core], dist[core], gain_limit=vif_gain,
                                variant=vif_variant, motion_ref=ref)
        motion, motion2 = features_from_sad_prev(
            sad[1:], n, has_prev=has_prev, has_next=has_next)
        adm2 = adm_features(ref[core], dist[core], gain_limit=adm_gain)
    return {
        "adm2": adm2,
        "motion": motion,
        "motion2": motion2,
        "vif_scale0": vif[:, 0],
        "vif_scale1": vif[:, 1],
        "vif_scale2": vif[:, 2],
        "vif_scale3": vif[:, 3],
    }


def fetch_features(feats: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Feature dict -> host numpy through one stacked device-to-host copy."""
    keys = sorted(feats)
    packed = to_host(torch.stack([feats[k] for k in keys]))
    return {k: packed[i] for i, k in enumerate(keys)}

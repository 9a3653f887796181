"""nu-SVR RBF score fusion as an ``nn.Module`` (port of pqa2_tpu/models/svr.py).

  features (N, F) --linear_rescale--> x
  K     = exp(-gamma * ||x - sv||^2)        direct differences, f32
  raw   = K @ coef - rho                    f32 product + reduction
  score = inverse rescale -> score_transform -> clip

The weights come from a loader model through :func:`svr_state_from_model`,
which is duck-typed: it takes a ``pqa2_tpu_torch.models.loader`` model and a
``pqa2_tpu.models.loader`` one alike, so the JAX predictor and this module
can be fed the same numbers. A bootstrap ensemble is one padded batch of M sub-models
(zero coefficients on padded support vectors contribute nothing).

Trap 10 (precision): the squared distances are direct ``(x - sv)^2``
differences, not the matmul expansion, and ``K @ coef`` is a full-f32
elementwise product and sum, never a TF32 matmul: the inverse rescale
(1/slopes[0], ~83x) amplifies any f32 noise straight into the score.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _is_bootstrap(model) -> bool:
    """A bootstrap ensemble carries its sub-models in ``.models``."""
    return hasattr(model, "models")


def svr_state_from_model(model) -> Dict[str, object]:
    """A loader model's numpy arrays -> the predictor's state.

    Array entries carry a leading sub-model axis M (1 for a single model):
    ``sv`` (M, n_sv, F), ``sv_coef`` (M, n_sv), ``slopes`` and
    ``intercepts`` (M, F+1), ``gamma`` and ``rho`` (M,), all float64;
    ``score_transform`` is (p0, p1, p2, out_gte_in) or None and
    ``score_clip`` (lo, hi) or None, both from sub-model 0."""
    models = tuple(model.models) if _is_bootstrap(model) else (model,)
    n_sv = max(m.n_sv for m in models)
    f = models[0].n_features
    sv = np.zeros((len(models), n_sv, f), dtype=np.float64)
    coef = np.zeros((len(models), n_sv), dtype=np.float64)
    for i, m in enumerate(models):
        sv[i, : m.n_sv] = m.sv
        coef[i, : m.n_sv] = m.sv_coef
    st = models[0].score_transform
    return {
        "sv": sv,
        "sv_coef": coef,
        "slopes": np.stack([m.slopes for m in models]).astype(np.float64),
        "intercepts": np.stack([m.intercepts for m in models]).astype(np.float64),
        "gamma": np.array([m.gamma for m in models], dtype=np.float64),
        "rho": np.array([m.rho for m in models], dtype=np.float64),
        "score_transform": (st.p0, st.p1, st.p2, st.out_gte_in) if st else None,
        "score_clip": tuple(models[0].score_clip) if models[0].score_clip else None,
    }


class ScorePredictor(nn.Module):
    """Batched prediction chain for M stacked sub-models.

    ``forward(features (N, F) f32) -> (N,)`` scores of sub-model 0 (the
    model itself for a single VMAFModel)."""

    def __init__(self, state: Dict[str, object], device="cpu"):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.register_buffer("sv", torch.as_tensor(state["sv"], **f32))
        self.register_buffer("coef", torch.as_tensor(state["sv_coef"], **f32))
        self.register_buffer("slopes", torch.as_tensor(state["slopes"], **f32))
        self.register_buffer("intercepts", torch.as_tensor(state["intercepts"], **f32))
        self.register_buffer("gamma", torch.as_tensor(state["gamma"], **f32))
        self.register_buffer("rho", torch.as_tensor(state["rho"], **f32))
        st = state["score_transform"]
        self.out_gte_in = bool(st[3]) if st else False
        self.register_buffer(
            "transform",
            torch.as_tensor([st[0], st[1], st[2]], **f32) if st else None)
        self.score_clip: Optional[Tuple[float, float]] = state["score_clip"]

    def all_scores(self, features: torch.Tensor) -> torch.Tensor:
        """(N, F) raw features -> (M, N) scores of every sub-model."""
        x = features.float()[None] * self.slopes[:, None, 1:] + self.intercepts[:, None, 1:]
        diff = x[:, :, None, :] - self.sv[:, None, :, :]          # (M, N, S, F)
        d2 = (diff * diff).sum(dim=-1)                            # (M, N, S)
        k = torch.exp(-self.gamma[:, None, None] * d2)
        # K @ coef as an f32 product and reduction over the support
        # vectors: no matmul, so TF32 cannot apply whatever
        # torch.backends.cuda.matmul.allow_tf32 says, and the reduction is
        # as accurate as JAX's HIGHEST dot (torch's CPU batched f32 matmul
        # measured 5x further from a float64 reference on vmaf_b_v0.6.3).
        raw = (k * self.coef[:, None, :]).sum(dim=-1) - self.rho[:, None]
        score = (raw - self.intercepts[:, None, 0]) / self.slopes[:, None, 0]
        if self.transform is not None:
            p0, p1, p2 = self.transform
            y = p0 + p1 * score + p2 * score * score
            score = torch.maximum(y, score) if self.out_gte_in else y
        if self.score_clip is not None:
            score = torch.clamp(score, float(self.score_clip[0]), float(self.score_clip[1]))
        return score

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.all_scores(features)[0]


class BootstrapPredictor(ScorePredictor):
    """A bootstrap ensemble: ``forward`` returns (primary (N,), all (M, N));
    sub-model 0 is libvmaf's primary prediction."""

    def forward(self, features: torch.Tensor):
        scores = self.all_scores(features)
        return scores[0], scores


def predictor_for_model(model, device="cpu") -> ScorePredictor:
    """The predictor module for a loader model, on ``device``."""
    cls = BootstrapPredictor if _is_bootstrap(model) else ScorePredictor
    return cls(svr_state_from_model(model), device=device)

# Frozen copy of the NumPy oracle golden/motion_int.py of the port, imports pointed
# at this package: the benchmark's reference imports nothing of the program.
"""Integer fixed-point motion — oracle.

Emulates libvmaf's ``VMAF_integer_feature_motion2`` path: 5-tap Q16 Gaussian
blur of the *reference* luma (the same Q16 window as VIF scale 2,
golden/fixedpoint.py:MOTION_FILTER_Q16), SAD between consecutive blurred
frames in Q8, normalised back to pixel units:

  vertical:   tmp  = (sum_f q16[f] * x + 128) >> 8      -> Q8 pixels
  horizontal: blur = (sum_f q16[f] * tmp + 32768) >> 16 -> Q8 pixels
  sad(t-1,t)  = sum |blur_t - blur_{t-1}|                (exact integer)
  motion[t]   = sad / (w*h*256)

motion2[t] = min(sad(t-1,t), sad(t,t+1)) with the same clip-boundary rules
as the float oracle (golden/motion.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from perfbench.reference.golden.fixedpoint import MOTION_FILTER_Q16
from perfbench.reference.golden.vif_int import _filt_h, _filt_v

_U64 = np.uint64


def blur_int(frame: np.ndarray, in_q: int = 0) -> np.ndarray:
    """(H, W) luma (Q{in_q} pixel codes) -> Q8 blurred plane (uint64)."""
    tmp = _filt_v(frame.astype(_U64), MOTION_FILTER_Q16, 8 + in_q)
    return _filt_h(tmp, MOTION_FILTER_Q16, 16)


def motion_features_int(
    frames: np.ndarray, bit_depth: int = 8
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, H, W) reference luma -> (motion, motion2), float64 (N,).

    >8-bit codes are carried natively: the vertical blur shift widens to
    ``bpc`` (in_q = depth-8 on the 8-bit pixel scale) and the SAD runs on
    the same Q8 planes as the 8-bit path."""
    n, h, w = frames.shape
    in_q = max(bit_depth - 8, 0)
    blurred = np.stack([blur_int(f, in_q) for f in frames])
    sads = np.array(
        [
            int(np.abs(blurred[i].astype(np.int64)
                       - blurred[i - 1].astype(np.int64)).sum())
            for i in range(1, n)
        ],
        dtype=np.float64,
    )
    sad_prev = sads / (w * h * 256.0)  # sad(t-1, t) for t in 1..n-1

    motion = np.concatenate([[0.0], sad_prev])
    fwd = np.concatenate([sad_prev, [np.inf]])
    motion2 = np.minimum(motion, fwd)
    motion2[0] = 0.0
    return motion, motion2

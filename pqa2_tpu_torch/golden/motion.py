# Copy of pqa2_tpu/golden/motion.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""Motion / motion2 temporal features — oracle.

``motion2`` is the second SVR input of every shipped model
(models/*.json feature_names; enabled via ``feature=name=motion`` in the
reference's libvmaf filter string, app/vmaf_analyzer.py:389).

Per frame t (on Gaussian-blurred luma, 5-tap window):
    sad(a, b)  = mean |blur(a) - blur(b)|
    motion[t]  = 0 if t == 0 else sad(t-1, t)
    motion2[t] = 0 if t == 0
                 else min(sad(t-1, t), sad(t, t+1)) if t+1 exists
                 else sad(t-1, t)

The t+1 term makes this the one temporally-dependent feature in VMAF — the
sharded pipeline handles it with a one-frame halo (pqa2_tpu/parallel).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from pqa2_tpu_torch.golden.filters import motion_filter, sep_filter2d


def blur_luma(frame: np.ndarray) -> np.ndarray:
    return sep_filter2d(frame.astype(np.float64), motion_filter())


def sad_mean(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean(np.abs(a - b)))


def motion_features(frames: np.ndarray) -> Tuple[List[float], List[float]]:
    """frames: (N, H, W) luma. Returns (motion, motion2) per-frame lists."""
    n = frames.shape[0]
    blurred = [blur_luma(frames[i]) for i in range(n)]
    sad_prev = [0.0] + [
        sad_mean(blurred[i - 1], blurred[i]) for i in range(1, n)
    ]
    motion = list(sad_prev)
    motion2 = []
    for t in range(n):
        if t == 0:
            motion2.append(0.0)
        elif t + 1 < n:
            motion2.append(min(sad_prev[t], sad_prev[t + 1]))
        else:
            motion2.append(sad_prev[t])
    return motion, motion2

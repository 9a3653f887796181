# Copy of pqa2_tpu/golden/log2lut.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
"""libvmaf's integer log2 lookup table — exact reconstruction.

libvmaf's integer VIF statistic never calls log2f per pixel. At init it
builds a quantised table

    log2_table[i] = round( (float)log2f(i) * 2048 )   for i in [32767, 65536]

(Q11 log2 of a 16-bit mantissa) and evaluates every per-pixel log as

    log2(x) ~= ( log2_table[ x >> k ] + 2048*k ) / 2048

where ``k = bit_length(x) - 16`` normalises x into [2^15, 2^16) by a
*truncating* right shift.  The table quantisation plus the truncated
mantissa are the only "log error" in libvmaf's integer path — so matching
the integer family bit-for-bit requires reproducing both, not computing a
better log (docs/CALIBRATION.md; the reference delegates scoring to this
code via ``ffmpeg -lavfi libvmaf``, app/vmaf_analyzer.py:406).

Table semantics reproduced here:

* ``log2f(i)`` — the correctly-rounded float32 log2 of the exact integer
  ``i`` (glibc's log2f is correctly rounded on this range; emulated as
  float64 log2 rounded once to float32).
* ``* 2048`` — exact in float32 (power-of-two scale).
* ``round`` — C round(): half away from zero, evaluated in double on the
  exact float32 product.

Everything downstream (normalisation shifts, integer accumulation of table
values) is pure integer arithmetic and therefore exact on any backend.
"""

from __future__ import annotations

import numpy as np

# Mantissa normalisation target: [2^15, 2^16).
MANTISSA_BITS = 16
LOG2_SCALE = 2048  # Q11

_TABLE = None


def log2_table() -> np.ndarray:
    """The 65537-entry uint16 table (values only defined for i >= 32767)."""
    global _TABLE
    if _TABLE is None:
        i = np.arange(65537, dtype=np.float64)
        i[0] = 1.0  # avoid log2(0); entries below 32767 are never read
        y32 = np.log2(i).astype(np.float32)  # correctly-rounded log2f
        prod = (y32 * np.float32(LOG2_SCALE)).astype(np.float32)  # exact
        vals = np.floor(prod.astype(np.float64) + 0.5)  # C round(), x>0
        t = np.zeros(65537, dtype=np.uint16)
        t[32767:] = vals[32767:].astype(np.uint16)
        _TABLE = t
    return _TABLE


def normalize16(x: np.ndarray) -> tuple:
    """Truncating normalisation of integers >= 2^16 into [2^15, 2^16).

    Returns (mantissa, k) with ``x >> k == mantissa`` — libvmaf's
    get_best16_from32/get_best16_from64 for the value ranges the VIF
    statistic feeds them (always >= 2^17: sigma_nsq alone is 2*65536).
    """
    x = np.asarray(x, dtype=np.uint64)
    # bit_length via float exponent would be inexact for >2^53; do it with
    # a shift cascade (branchless, vectorised).
    k = np.zeros(x.shape, dtype=np.int64)
    v = x.copy()
    for step in (32, 16, 8, 4, 2, 1):
        over = v >= (np.uint64(1) << np.uint64(MANTISSA_BITS + step - 1))
        v = np.where(over, v >> np.uint64(step), v)
        k = k + np.where(over, step, 0)
    # v in [2^15, 2^16) for x >= 2^15
    return v.astype(np.int64), k


_BREAKPOINTS = None


def breakpoints_ext() -> np.ndarray:
    """Sorted step positions of the table — the gather-free device form.

    ``t[m] = log2_table()[m]`` is monotone over m in [2^15, 2^16) with unit
    steps through exactly 2049 values [30720, 32768].  Device backends
    (ops/pallas_vif_int.py) therefore recover t[m] exactly WITHOUT a
    per-pixel gather, from an approximate f32 candidate plus comparisons
    against the integer breakpoints returned here:

        u(m) = t[m] - 30720 = #{ j in [1, 2048] : B[j] <= m }
             = idx - 2 + [m >= B(idx-1)] + [m >= B(idx)] + [m >= B(idx+1)]

    for ANY candidate ``idx = clip(round(log2~(m) * 2048) - 30720, 1,
    2048)`` within +-1 of the true value — a window every f32 log2 meets
    with ~100x margin (pinned exhaustively in tests/test_integer.py).

    Returns int32 ``B_ext[0..2049]``: B_ext[j] for j in [1, 2048] is the
    smallest mantissa with ``t[m] = 30720 + j``; B_ext[0] = 32768 (<=
    every mantissa) and B_ext[2049] = 65536 (> every mantissa) close the
    formula at the clip edges.  Consecutive differences lie in [6, 23],
    so (B>>8, B&255, dB) all pack exactly into bfloat16 for the MXU
    one-hot fetch.
    """
    global _BREAKPOINTS
    if _BREAKPOINTS is None:
        t = log2_table().astype(np.int64)
        m_all = np.arange(32768, 65536)
        js = np.arange(1, 2049)
        first = np.searchsorted(t[m_all], 30720 + js, side="left")
        ext = np.empty(2050, dtype=np.int32)
        ext[0] = 32768
        ext[1:2049] = m_all[first]
        ext[2049] = 65536
        _BREAKPOINTS = ext
    return _BREAKPOINTS


def log2_q11(x: np.ndarray) -> np.ndarray:
    """Quantised log2 exactly as the integer path computes it.

    Returns float64 ``(log2_table[m] + 2048*k) / 2048`` — only for
    analysis/tests; the oracle statistic accumulates table values and k
    separately as integers, like libvmaf.
    """
    m, k = normalize16(x)
    t = log2_table()
    return (t[m].astype(np.float64) + LOG2_SCALE * k) / LOG2_SCALE

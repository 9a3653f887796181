"""Stage ``vif_int``: integer VIF over four scales with the motion SAD of
the reference (libvmaf's integer_vif and integer_motion2), per scored frame.

Work from the algorithm and the frame's shape, whatever implements it:

* bytes: the reference and distorted luma read once, at the dtype the main
  path hands the stage (uint8 codes at 8 bits; 4-byte samples deeper: f32
  on the 8-bit scale in memory, int32 codes from files), and the outputs
  (seven int64 accumulators a scale, the motion SAD) written once. Planes
  between scales are not counted: an implementation could keep them on
  chip, so the count stays a lower bound.
* operations: at each scale of F taps, five filtered planes (two means,
  three second moments) in a column and a row pass at a multiply and an
  add a tap (20 F a pixel), the three products (3) and the statistic (40);
  the decimation to the next scale blurs two planes with that scale's
  taps at the kept rows, then the kept columns (12 F per kept pixel); the
  motion blur of the reference (5 taps, two passes: 20 a pixel) and its
  difference with the previous frame (subtract, absolute, add: 3).
"""

PATTERNS = [r"\bvif_int_scale_kernel\b", r"\bmotion_blur_kernel\b", r"\bmotion_sad_kernel\b"]

TAPS = (17, 9, 5, 3)


def work(cfg):
    """(bytes, operations) of one scored frame."""
    h, w = int(cfg["height"]), int(cfg["width"])
    in_bytes = 1 if int(cfg["bit_depth"]) == 8 else 4
    nbytes = 2 * h * w * in_bytes + 4 * 7 * 8 + 8
    ops = 0
    for s, f in enumerate(TAPS):
        if s > 0:
            h, w = (h + 1) // 2, (w + 1) // 2
            ops += 12 * f * h * w
        ops += h * w * (20 * f + 3 + 40)
    p0 = int(cfg["height"]) * int(cfg["width"])
    ops += p0 * (20 + 3)
    return nbytes, ops

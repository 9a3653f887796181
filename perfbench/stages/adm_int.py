"""Stage ``adm_int``: integer ADM2 over four db2 levels (libvmaf's
integer_adm), per scored frame.

* bytes: the reference and distorted luma read once at the dtype the main
  path hands the stage (uint8 at 8 bits, 4-byte samples deeper) and the
  pooled sums (four levels, three bands, numerator and denominator, int64)
  written once; the approximation planes between levels are not counted.
* operations, per level whose bands hold b pixels: the DWT of both planes
  (96 a band pixel and plane) and the decoupling, contrast-sensitivity
  weighting, masking and cube pooling of the three bands (110 a band
  pixel).
"""

PATTERNS = [r"\badm_int_level_kernel\b"]

LEVELS = 4


def work(cfg):
    """(bytes, operations) of one scored frame."""
    h, w = int(cfg["height"]), int(cfg["width"])
    in_bytes = 1 if int(cfg["bit_depth"]) == 8 else 4
    nbytes = 2 * h * w * in_bytes + LEVELS * 3 * 2 * 8
    ops = 0
    for _ in range(LEVELS):
        h, w = (h + 1) // 2, (w + 1) // 2
        ops += 2 * h * w * 96 + h * w * 110
    return nbytes, ops

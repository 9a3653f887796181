"""Stage ``ssim_sse``: ffmpeg's SSIM (4x4 block sums, 8x8 windows on a
4-pixel grid) and the squared error for PSNR, on the three planes of a
4:2:0 frame, per scored frame.

* bytes: each plane of the reference and the distorted frame read once as
  the main path hands the stage (f32 samples on the 8-bit scale), and a
  float64 SSIM and SSE per plane written once.
* operations: 13 a pixel (the four block sums of the two planes, their
  squares and product, the error's square and sum, and the window formula
  spread over its pixels).
"""

PATTERNS = [r"\bssim_sse_kernel\b", r"\bssim_finish_kernel\b"]


def work(cfg):
    """(bytes, operations) of one scored frame."""
    h, w = int(cfg["height"]), int(cfg["width"])
    px = h * w + 2 * ((h + 1) // 2) * ((w + 1) // 2)
    return 2 * px * 4 + 3 * 2 * 8, px * 13

"""NumPy oracles of the port: float64/uint64 specifications of every feature.

Copies of the modules of ``pqa2_tpu/golden`` that the port uses, with
their imports pointed at this package (the port imports nothing of
``pqa2_tpu``). The plain PyTorch versions take their filter taps, Q16/Q15
tables, the log2 table and constants from here, and ``chip_smoke.py``
holds the card's features against these oracles. The package exports the
JAX package's five oracle entry points; the integer-family oracles, tables
and constants are in the submodules.
"""

from pqa2_tpu_torch.golden.vif import vif_features
from pqa2_tpu_torch.golden.adm import adm_features
from pqa2_tpu_torch.golden.motion import motion_features
from pqa2_tpu_torch.golden.ssim import ssim_frame
from pqa2_tpu_torch.golden.psnr import psnr_frame

__all__ = [
    "vif_features",
    "adm_features",
    "motion_features",
    "ssim_frame",
    "psnr_frame",
]

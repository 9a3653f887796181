"""Plain PyTorch versions of the feature ops and the CUDA kernel wrappers
(``cuda_*``, the counterparts of pqa2_tpu/ops/pallas_*.py), and the
colorspace conversions.

Exported here: each name of pqa2_tpu/ops/__init__.py whose counterpart has
that name. The JAX package's ``ssim_plane_batched`` has none: the port's SSIM
is ``ssim.ssim_sse_plane_plain`` and its kernel ``cuda_ssim.ssim_sse_plane``
(SSIM and the SSE of one plane in one pass; ROADMAP lists the name)."""

from pqa2_tpu_torch.ops.filters import (
    dwt2_batched,
    sep_filter_batched,
)
from pqa2_tpu_torch.ops.vif import vif_features_batched
from pqa2_tpu_torch.ops.adm import adm_features_batched
from pqa2_tpu_torch.ops.motion import blur_batched, motion_features, sad_pairs
from pqa2_tpu_torch.ops.psnr import psnr_planes_batched
from pqa2_tpu_torch.ops.colorspace import (
    chroma_420_to_444,
    chroma_422_to_420,
    chroma_444_to_420,
    planar_to_uyvy422,
    rgb_to_yuv,
    uyvy422_to_planar,
    yuv_to_rgb,
)

"""Plain PyTorch versions of the feature ops and the CUDA kernel wrappers
(``cuda_*``, the counterparts of pqa2_tpu/ops/pallas_*.py), and the
colorspace conversions, exported here as pqa2_tpu/ops/__init__.py does."""

from pqa2_tpu_torch.ops.colorspace import (
    chroma_420_to_444,
    chroma_422_to_420,
    chroma_444_to_420,
    planar_to_uyvy422,
    rgb_to_yuv,
    uyvy422_to_planar,
    yuv_to_rgb,
)

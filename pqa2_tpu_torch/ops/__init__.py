"""Plain PyTorch versions of the feature ops and the CUDA kernel wrappers
(``cuda_*``, the counterparts of pqa2_tpu/ops/pallas_*.py)."""

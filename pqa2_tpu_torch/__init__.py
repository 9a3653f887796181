"""pqa2_tpu_torch — the PyTorch/CUDA port of pqa2_tpu for NVIDIA Hopper.

Both feature families of ``pqa2_tpu`` run here in PyTorch, plus PSNR and
SSIM: the integer family of the default model ``vmaf_v0.6.1`` and the float
family of the ``vmaf_float_*`` models. Every TPU Pallas kernel of those
paths is rewritten as a hand-written CUDA C++ kernel for ``sm_90a``
(``csrc/``, built with nvcc on first use).

Layout mirrors ``pqa2_tpu`` so each module's counterpart is easy to find:

  ops/       plain PyTorch versions (``filters``, ``vif``, ``adm``,
             ``motion``, ``vif_int``, ``motion_int``, ``adm_int``,
             ``ssim``, ``psnr``) and the kernel wrappers (``cuda_vif``,
             ``cuda_adm``, ``cuda_motion``, ``cuda_vif_int``,
             ``cuda_adm_int``, ``cuda_ssim``)
  golden/    copies of the numpy oracles, tables and constants
  io/        copies of the y4m / cv2 / ffmpeg-pipe video readers
  models/    copies of the libvmaf model loader and registry with the
             packaged ``data/*.npz`` weights, and the nu-SVR predictor as
             an ``nn.Module``
  pipeline/  feature extraction, streaming clip scoring, JSON output
  app/       ``VMAFAnalyzer`` with the reference's results dict/artifacts
  utils/     chunk padding, and copies of ``signals`` and ``profiling``
  csrc/      CUDA sources

Every public entry point takes an explicit ``device``. Kernel wrappers use
their plain version only for tensors on the CPU; for CUDA tensors they
launch the kernel or raise. The package is self-contained: it imports
neither JAX nor anything of ``pqa2_tpu``, and keeps its own copies of the
framework-free modules it needs.
"""

__version__ = "0.1.0"

"""pqa2_tpu_torch — the PyTorch/CUDA port of pqa2_tpu for NVIDIA Hopper.

The default scoring path of ``pqa2_tpu`` (VMAF ``vmaf_v0.6.1`` on the
integer feature family, plus PSNR and SSIM) runs here in PyTorch, with the
four TPU Pallas kernels of that path rewritten as hand-written CUDA C++
kernels for ``sm_90a`` (``csrc/``, built with nvcc on first use).

Layout mirrors ``pqa2_tpu`` so each module's counterpart is easy to find:

  ops/       plain PyTorch versions (``vif_int``, ``motion_int``,
             ``adm_int``, ``ssim``, ``psnr``) and the kernel wrappers
             (``cuda_vif_int``, ``cuda_adm_int``, ``cuda_ssim``)
  models/    the nu-SVR predictor as an ``nn.Module``
  pipeline/  feature extraction, streaming clip scoring, JSON output
  app/       ``VMAFAnalyzer`` with the reference's results dict/artifacts
  csrc/      CUDA sources

Every public entry point takes an explicit ``device``. Kernel wrappers use
their plain version only for tensors on the CPU; for CUDA tensors they
launch the kernel or raise. The package never imports JAX: it reuses only
the framework-free parts of ``pqa2_tpu`` (``golden``, ``models.loader``,
``models.registry``, ``io``, ``utils.signals``/``utils.profiling``).
"""

__version__ = "0.1.0"

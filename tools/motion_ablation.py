#!/usr/bin/env python3
"""Where kernel 7 of pqa2_tpu_torch (the float motion SAD,
``pqa2_tpu_torch/csrc/motion.cu``) spends its time on the card.

    python3 tools/motion_ablation.py    # needs one sm_90 card and nvcc

Two variants are built from the kernel's own source by text substitution
(one nvcc each, loaded with ctypes beside the port's library):

  general   every tile staged through the border path (a reflected row
            and a bounds test per 4-column chunk), no interior fast path;
            the result must equal the kernel's in every bit;
  no_blur   the staging, the difference and the sums without the blur:
            the time the copies into shared memory set by themselves.

For 34 frames of 1920x1080 and of 3840x2160 it prints CUDA-event times
of the kernel and of each variant, in the order kernel, variant, variant,
kernel, and of ``torch.sum`` over the same frames: a full read of the same
bytes (not the same function), the card's practical read rate at this size.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "build", "motion_ablation")

_INTERIOR = """  const bool interior = vec != 0 && x0 >= CPAD && x0 + TW + CPAD <= W && y0 >= HALF &&
                        y0 + TH + HALF <= H;"""
_BLUR = "  constexpr int NC = PX + 2;\n"
_NO_BLUR = """  const float v = s[(r0 + (lane & 7)) * SW + CPAD + c0];
#pragma unroll
  for (int r = 0; r < PX; ++r) {
#pragma unroll
    for (int c = 0; c < PX; ++c) {
      if (add && r < rows && c < cols) sad += static_cast<double>(fabsf(__fsub_rn(v, prev[r][c])));
      prev[r][c] = v;
    }
  }
  return;
"""
VARIANTS = {"general": (_INTERIOR, "  const bool interior = false;"),
            "no_blur": (_BLUR, _NO_BLUR + _BLUR)}


def build(build_mod, name, old, new):
    """nvcc of csrc/motion.cu with ``old`` replaced by ``new`` -> its CDLL."""
    src = (build_mod.CSRC_DIR / "motion.cu").read_text()
    if src.count(old) != 1:
        raise RuntimeError(f"{name}: the substituted text is not in motion.cu once")
    os.makedirs(OUT, exist_ok=True)
    cu, lib = os.path.join(OUT, f"{name}.cu"), os.path.join(OUT, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src.replace(old, new))
    subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-I", str(build_mod.CSRC_DIR),
                    "-shared", "-o", lib, cu], check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


def main() -> int:
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("motion_ablation: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from pqa2_tpu_torch import _build
    from pqa2_tpu_torch._device import require_cuda
    from pqa2_tpu_torch.golden.filters import motion_filter
    from pqa2_tpu_torch.ops import cuda_motion
    from pqa2_tpu_torch.ops.cuda_vif_int import host_taps

    dev = require_cuda("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.library(dev)
    libs = {k: build(_build, k, *v) for k, v in VARIANTS.items()}
    taps = host_taps("motion_f32", np.asarray(motion_filter(), np.float32), ctypes.c_float)
    p, i = ctypes.c_void_p, ctypes.c_int

    def variant(lib, m):
        n, h, w = m.shape
        tiles = lib.pqa2_motion_f32_tiles
        tiles.argtypes, tiles.restype = [i, i], i
        fn = lib.pqa2_motion_sad_f32
        fn.argtypes, fn.restype = [p, i, i, i, p, i, p, p, p], i
        part = torch.empty((n, tiles(h, w)), dtype=torch.float64, device=dev)
        sad = torch.empty((n,), dtype=torch.float32, device=dev)

        def run():
            if fn(_build.ptr(m), n, h, w, taps, cuda_motion.RUN, _build.ptr(part),
                  _build.ptr(sad), _build.stream(dev)) != 0:
                raise RuntimeError("variant launch failed")
            return sad
        return run

    def ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    g = torch.Generator(device=dev).manual_seed(1)
    for h, w in ((1080, 1920), (2160, 3840)):
        yy = torch.arange(h, device=dev, dtype=torch.float32)[:, None]
        xx = torch.arange(w, device=dev, dtype=torch.float32)[None, :]
        m = torch.stack([128 + 50 * torch.sin((xx + 3 * t) / 37.0) * torch.cos((yy - 1.5 * t) / 53.0)
                         + 20 * torch.rand((h, w), generator=g, device=dev)
                         for t in range(34)]).clamp(0, 255).round()
        kernel = lambda: cuda_motion.motion_sad(m)  # noqa: E731
        if not torch.equal(variant(libs["general"], m)(), kernel()):
            raise AssertionError("the general staging path changed the result")
        for name, lib in libs.items():
            run = variant(lib, m)
            t = [ms(kernel), ms(run), ms(run), ms(kernel)]
            print(f"[ablation] {w}x{h}, 34 frames: kernel {t[0]:.4f}, {name} {t[1]:.4f}, "
                  f"{name} {t[2]:.4f}, kernel {t[3]:.4f} ms [{card}]", flush=True)
        print(f"[ablation] {w}x{h}, 34 frames: torch.sum over the same "
              f"{m.numel() * 4 / 1e6:.1f} MB {ms(lambda: m.sum()):.4f} ms [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

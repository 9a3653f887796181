#!/usr/bin/env python3
"""Where the bookend statistics pass of pqa2_tpu_torch
(``pqa2_tpu_torch/align/stats.py:_stats_thumb_chunk``) spends its time on
the card.

    python3 tools/stats_pass_ablation.py    # needs one sm_90 card

On two 64-frame 1920x1080 uint8 chunks, smooth moving content alone and the
same with 20 uniform frames (10 at luma 16, 10 at 235: a capture's lead-in
and bookend), it prints CUDA-event times of the whole pass and of its
histogram in two forms:

  chunk     one ``torch.bincount`` over the chunk, 64 x 256 int64 bins: too
            many for a block's shared memory, so torch counts in global
            memory;
  per 8     one ``torch.bincount`` per 8 frames, 8 x 256 bins, counted in
            shared memory (the form the pass uses).

Both forms give the same counts (checked). The order is pass, chunk, per 8,
per 8, chunk, pass.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def hist_chunk(torch, frames):
    n = frames.shape[0]
    idx = frames.to(torch.int32)
    idx += torch.arange(n, dtype=torch.int32, device=frames.device).view(n, 1, 1) * 256
    return torch.bincount(idx.view(-1), minlength=n * 256).view(n, 256)


def hist_per8(torch, frames):
    parts = []
    for s in range(0, frames.shape[0], 8):
        sub = frames[s: s + 8]
        k = sub.shape[0]
        idx = sub.to(torch.int32)
        idx += torch.arange(k, dtype=torch.int32, device=frames.device).view(k, 1, 1) * 256
        parts.append(torch.bincount(idx.view(-1), minlength=k * 256).view(k, 256))
    return torch.cat(parts)


def main() -> int:
    import torch

    from chip_smoke import card_line, smooth_frames, time_call
    from pqa2_tpu_torch._device import require_cuda
    from pqa2_tpu_torch.align.stats import _stats_thumb_chunk

    if not torch.cuda.is_available():
        print("stats_pass_ablation: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    device = require_cuda("cuda")
    card = card_line()
    print(card)
    content = smooth_frames(torch, 64, 1080, 1920, 31, device)
    uniform = content.clone()
    uniform[:10] = 16
    uniform[10:20] = 235
    for label, chunk in (("content", content), ("20 uniform frames", uniform)):
        if not torch.equal(hist_chunk(torch, chunk), hist_per8(torch, chunk)):
            raise AssertionError(f"{label}: the two histogram forms differ")
        if not torch.equal(_stats_thumb_chunk(chunk)[:, 2:258].long(), hist_per8(torch, chunk)):
            raise AssertionError(f"{label}: the pass's histogram differs")
        cases = (("pass", lambda: _stats_thumb_chunk(chunk)),
                 ("chunk", lambda: hist_chunk(torch, chunk)),
                 ("per 8", lambda: hist_per8(torch, chunk)))
        times = {name: [] for name, _ in cases}
        for name, fn in cases + cases[::-1]:
            times[name].append(time_call(torch, fn, 10))
        print(f"[stats] 64 x 1920x1080 uint8, {label}: "
              + "; ".join(f"{name} {' / '.join(f'{t:.3f}' for t in ts)} ms"
                          for name, ts in times.items()) + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

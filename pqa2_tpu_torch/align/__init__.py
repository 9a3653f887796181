"""Bookend temporal alignment (port of pqa2_tpu/align).

One batched pass on the device computes per-frame luma mean, standard
deviation, histogram and thumbnail for the whole capture; every brightness
threshold is then evaluated on the host from the histograms, and alignment
produces frame index ranges into the decoded clips.
"""

from pqa2_tpu_torch.align.stats import frame_luma_stats
from pqa2_tpu_torch.align.bookend import (
    Bookend,
    BookendConfig,
    BookendDetector,
    detect_bookends,
)
from pqa2_tpu_torch.align.temporal import (
    AlignmentResult,
    align_bookend_clips,
    refine_offset_xcorr,
)

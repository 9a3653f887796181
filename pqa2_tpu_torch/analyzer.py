"""Convenience alias: ``from pqa2_tpu_torch.analyzer import VMAFAnalyzer``
(port of pqa2_tpu/analyzer.py).

The engine layer lives in pqa2_tpu_torch.app; this module re-exports the
most commonly used classes at a short path.
"""

from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalysisThread, VMAFAnalyzer
from pqa2_tpu_torch.app.bookend_aligner import BookendAligner, BookendAlignmentThread
from pqa2_tpu_torch.app.reference_analyzer import ReferenceAnalyzer

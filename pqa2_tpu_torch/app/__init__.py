"""Engine layer: the analyzer, the bookend aligner, the reference analyzer,
the capture manager, the report generator, the results store and the
decode-once workflow, with the reference's results dicts, signals and
artifacts. The scoring service is ``app.service``."""

from pqa2_tpu_torch.app.options_manager import OptionsManager
from pqa2_tpu_torch.app.utils import FileManager
from pqa2_tpu_torch.app.vmaf_analyzer import VMAFAnalyzer, VMAFAnalysisThread
from pqa2_tpu_torch.app.bookend_aligner import BookendAligner, BookendAlignmentThread
from pqa2_tpu_torch.app.reference_analyzer import (
    ReferenceAnalyzer,
    ReferenceAnalysisThread,
)
from pqa2_tpu_torch.app.capture import CaptureManager, CaptureState
from pqa2_tpu_torch.app.report_generator import ReportGenerator, ReportGeneratorThread
from pqa2_tpu_torch.app.workflow import CombinedWorkflowThread, run_combined_workflow
from pqa2_tpu_torch.app.results_store import ResultsStore

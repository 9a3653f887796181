# Copy of pqa2_tpu/ui/tabs/__init__.py with its imports pointed at this package:
# the port keeps its own copy and imports nothing of pqa2_tpu.
from pqa2_tpu_torch.ui.tabs.setup_tab import SetupTab
from pqa2_tpu_torch.ui.tabs.capture_tab import CaptureTab
from pqa2_tpu_torch.ui.tabs.analysis_tab import AnalysisTab
from pqa2_tpu_torch.ui.tabs.results_tab import ResultsTab
from pqa2_tpu_torch.ui.tabs.options_tab import OptionsTab
from pqa2_tpu_torch.ui.tabs.help_tab import HelpTab

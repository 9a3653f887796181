"""Shared utilities: Qt-free signals, logging setup (and, in ``profiling``,
the torch.profiler trace and the throughput meter)."""

from pqa2_tpu_torch.utils.signals import Signal
from pqa2_tpu_torch.utils.logs import setup_logging

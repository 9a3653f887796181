"""``python -m pqa2_tpu_torch score REF DIST`` — same as ``python -m pqa2_tpu_torch.cli``."""

import sys

from pqa2_tpu_torch.cli import main

sys.exit(main())

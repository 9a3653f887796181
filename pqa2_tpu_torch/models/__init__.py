"""Models of the port: the libvmaf model loader and registry (copies of
``pqa2_tpu/models/{loader,registry}.py`` with the nine packaged ``data/*.npz``
files) and the nu-SVR predictor as an ``nn.Module`` (``svr.py``, imported
only where scores are computed)."""

from pqa2_tpu_torch.models.loader import (
    VMAFModel,
    BootstrapModel,
    load_model,
    parse_model_json,
)
from pqa2_tpu_torch.models.registry import available_models, get_model

__all__ = [
    "VMAFModel",
    "BootstrapModel",
    "load_model",
    "parse_model_json",
    "available_models",
    "get_model",
]

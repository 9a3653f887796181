"""Models of the port: the libvmaf model loader and registry (copies of
``pqa2_tpu/models/{loader,registry}.py`` with the nine packaged ``data/*.npz``
files) and the nu-SVR predictor as an ``nn.Module`` (``svr.py``)."""

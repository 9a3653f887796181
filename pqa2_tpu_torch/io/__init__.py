"""Video ingest of the port: y4m, OpenCV when present, and the ffmpeg pipe.

Copies of ``pqa2_tpu/io/{y4m,video,ffmpeg_pipe}.py`` with their imports
pointed at this package. The JAX package's native decode/write pump
(``pqa2_tpu/io/native.py``) is not part of the port. Import the submodules
directly; this package imports none of them.
"""

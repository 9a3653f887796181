"""NumPy oracles of the port: float64/uint64 specifications of every feature.

Copies of the modules of ``pqa2_tpu/golden`` that the port uses, with
their imports pointed at this package (the port imports nothing of
``pqa2_tpu``). The plain PyTorch versions take their filter taps, Q16/Q15
tables, the log2 table and constants from here, and ``chip_smoke.py``
holds the card's features against these oracles. Import the submodules
directly; this package imports none of them.
"""

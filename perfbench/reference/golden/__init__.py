"""Frozen copies of the port's NumPy oracles (float64/uint64 libvmaf and
ffmpeg semantics)."""

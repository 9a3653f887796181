"""Feature extraction, streaming clip scoring and libvmaf-schema JSON."""

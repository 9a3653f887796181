"""Small helpers shared by the pipeline."""

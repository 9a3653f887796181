"""The nu-SVR score predictor (weights come from pqa2_tpu.models.registry)."""

"""Quantization-error and architecture analysis (port of ``mixdq_tpu/analysis/``)."""

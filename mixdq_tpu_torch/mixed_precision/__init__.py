"""The metric-decoupled mixed-precision search (port of ``mixdq_tpu/mixed_precision/``)."""

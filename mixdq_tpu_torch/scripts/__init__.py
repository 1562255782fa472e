"""Command-line entry points of the port (``python -m
mixdq_tpu_torch.scripts.<name>``)."""

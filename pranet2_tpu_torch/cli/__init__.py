"""Command-line entry points of the port (``python -m
pranet2_tpu_torch.cli.<name>``)."""

"""Command-line entry points of the port (``python -m pmhc_tpu_torch.cli.<name>``)."""

"""Command-line entry points of the port (``python -m pmhc_tpu_torch.cli.<name>``)."""

MULTI_GPU = "multi-device meshes are not ported yet: ROADMAP Queue 1, multi-GPU"

"""Command-line entry points of the port (``python -m gvl_tpu_torch.scripts.<name>``)."""

"""Command-line entry points of the port (``python -m dro_sfm_torch.scripts.<name>``)."""

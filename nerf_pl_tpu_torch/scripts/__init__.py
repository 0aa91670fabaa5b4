"""Measurement scripts run on the card (``python -m
nerf_pl_tpu_torch.scripts.<name>``)."""

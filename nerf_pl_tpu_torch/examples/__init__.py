"""Worked examples run as scripts (``python -m
nerf_pl_tpu_torch.examples.<name>``): the orbit render of a trained
checkpoint and the inspection of a shadow scene."""

"""Positional encoding, the NeRF MLP and camera helpers."""

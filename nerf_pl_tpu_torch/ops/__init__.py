"""Rays, sampling, searchsorted, compositing, the fused MLP and the
renderer."""

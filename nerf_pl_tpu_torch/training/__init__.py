"""Checkpoints in the JAX package's msgpack format."""

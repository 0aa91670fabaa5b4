"""The vanilla-NeRF trainer, losses, metrics, Adam with the step-LR
schedule, run logging, and checkpoints in the JAX package's msgpack
format."""

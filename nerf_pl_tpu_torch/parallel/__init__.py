"""Data parallelism over ``torch.distributed`` (``nerf_pl_tpu/parallel``)."""
from .mesh import (Mesh, all_gather_tiled, allreduce_grads,
                   initialize_distributed, make_mesh, process_allgather,
                   replicate, shard_rays)

__all__ = ["Mesh", "initialize_distributed", "make_mesh", "shard_rays",
           "replicate", "process_allgather", "all_gather_tiled",
           "allreduce_grads"]

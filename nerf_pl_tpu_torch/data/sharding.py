"""Per-host frame-shard selection shared by every loader that supports
``--per_host_data`` (blender, llff, efficient_sm, rgb_sm); the port's own
copy of ``nerf_pl_tpu/data/sharding.py``."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def wrap_pad_shard(
    items: Sequence, frame_shard: Tuple[int, int], what: str = "frames"
) -> List:
    """``items[offset::step]``, wrap-padded to ``ceil(len(items)/step)``.

    DistributedSampler-style semantics: unbalanced hosts REPEAT their
    leading items so every host contributes EQUAL rows —
    ``shard_rays(local=True)`` truncates to the global MIN rows-per-device,
    which would otherwise permanently DROP the larger hosts' trailing
    frames.  Raises on an empty shard (more hosts than items)."""
    offset, step = frame_shard
    local = list(items[offset::step])
    if not local:
        raise ValueError(
            f"frame_shard {frame_shard}: host {offset} gets no {what} "
            f"({len(items)} over {step} hosts) — use fewer hosts or drop "
            "--per_host_data"
        )
    target = -(-len(items) // step)
    return local + local[: target - len(local)]


def equalize_rows(buffers, n_local: int, target: int):
    """Wrap-pad row-aligned host buffers to ``target`` rows.

    Content-dependent per-ray filters (e.g. efficient_sm's ``white_pix``)
    keep DIFFERENT row counts per host even after wrap-padded frame shards;
    ``shard_rays(local=True)`` would then truncate every host to the global
    MIN and permanently drop the larger hosts' trailing rays.  Each host
    wrap-repeats its own rows to the global max instead — DistributedSampler
    pad semantics, slight oversampling, zero loss."""
    if target <= n_local:
        return list(buffers)
    idx = np.arange(target) % n_local
    return [b[idx] for b in buffers]

"""Data parallelism over clip streams: one process a card (mesh.py)."""

from .mesh import (Mesh, count_collectives, gather_clips, init_from_env,
                   make_mesh, replicate, shard_clips)

__all__ = ["Mesh", "count_collectives", "gather_clips", "init_from_env",
           "make_mesh", "replicate", "shard_clips"]

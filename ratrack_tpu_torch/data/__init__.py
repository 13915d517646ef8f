"""Frame records and synthetic clips (numpy + torch, no JAX)."""

from .frames import FrameBatch, empty_frame, to_tensors
from .synthetic import synthetic_clip, stack_frames

__all__ = ["FrameBatch", "empty_frame", "to_tensors", "synthetic_clip",
           "stack_frames"]

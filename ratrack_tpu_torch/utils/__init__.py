"""Weight conversion from the JAX package's variables."""

from .convert import from_flax_variables

__all__ = ["from_flax_variables"]

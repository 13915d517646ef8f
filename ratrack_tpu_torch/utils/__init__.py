"""Weight conversion: flax variables and reference torch checkpoints."""

from .convert import (convert_reference_state_dict,
                      export_reference_state_dict, from_flax_variables,
                      load_reference_checkpoint, save_reference_checkpoint)

__all__ = ["convert_reference_state_dict", "export_reference_state_dict",
           "from_flax_variables", "load_reference_checkpoint",
           "save_reference_checkpoint"]

"""flax variables of the JAX Track4D -> state_dict of the port's Track4D.

The port's parameter names mirror the flax tree, so the conversion is a
flatten plus a Dense-kernel transpose:

  params/.../kernel   (in, out)  -> .../weight  (out, in)
  params/.../bias                -> .../bias
  params/.../scale    (BN)       -> .../weight
  params/bin_score               -> bin_score
  batch_stats/.../mean           -> .../running_mean
  batch_stats/.../var            -> .../running_var

Input leaves are numpy arrays (or anything np.asarray takes), so this
module needs no JAX. The published reference checkpoint loads through the
JAX package's own converter first:
    from_flax_variables(convert_reference_state_dict(sd)[0])
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping) or hasattr(val, "items"):
            yield from _flatten(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def from_flax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """{"params", "batch_stats"} tree -> state_dict (float32 CPU tensors)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, leaf_map in (("params", _PARAM_LEAF),
                                 ("batch_stats", _STAT_LEAF)):
        for path, val in _flatten(variables.get(collection, {})):
            arr = np.asarray(val, dtype=np.float32)
            *mods, leaf = path
            if leaf in leaf_map:
                if leaf == "kernel":
                    arr = arr.T
                name = ".".join([*mods, leaf_map[leaf]])
            elif not mods:                    # root parameter (bin_score)
                name = leaf
            else:
                raise KeyError(f"unexpected leaf {'/'.join(path)}")
            out[name] = torch.tensor(np.ascontiguousarray(arr))
    return out

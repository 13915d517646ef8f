"""Weight conversion: flax variables of the JAX Track4D, and the reference
RaTrack torch checkpoints, to and from the port's state_dict.

The port's parameter names mirror the flax tree, so `from_flax_variables`
is a flatten plus a Dense-kernel transpose:

  params/.../kernel   (in, out)  -> .../weight  (out, in)
  params/.../bias                -> .../bias
  params/.../scale    (BN)       -> .../weight
  params/bin_score               -> bin_score
  batch_stats/.../mean           -> .../running_mean
  batch_stats/.../var            -> .../running_var

Input leaves are numpy arrays (or anything np.asarray takes), so this
module needs no JAX.

The reference distributes its weights as a torch state_dict (a `.t7`,
`checkpoint/track4d_radar/models/model.last.t7`).
`convert_reference_state_dict` maps its names straight onto the port's
(the counterpart of the JAX package's
`ratrack_tpu/utils/convert.py::convert_reference_state_dict`, :148, which
maps them onto the flax tree): 1x1 Conv2d weights (O, I, 1, 1) and Linear
weights (O, I) become the port's (O, I) weights, BatchNorm weight / bias /
running statistics keep their roles, and

  pn_head.sa{1,2,3}.mlps.{s}.layer{i}.conv | .bn.bn
      -> pn_head.sa*.mlp_{s}.dense_{i} | .bn_{i}
  pn_head.fp{1,2,3}.mlp.layer0    -> pn_head.fp*.mlp.dense_0 | .bn_0
  fc_layer.mlp_convs.{i}          -> fc_layer.mlp.dense_{i}
  fc_layer.weightnet{j}.mlp_convs.{0,1,2}
      -> fc_layer.weightnet{j}.dense_0 | _1 | _out
  fd_layer.mse.*                  -> as pn_head, under fd_layer.mse
  fd_layer.{fp,cp}.sf_mlp.{i}.0 | .1
      -> fd_layer.{fp,cp}.mlp.dense_{i} | .bn_{i}
  fd_layer.fp.conv2, fd_layer.cp.conv2
      -> fd_layer.fp.out, fd_layer.cp.conv_out
  fd_layer.torchGRU.{weight,bias}_{ih,hh}_l{l}
      -> fd_layer.gru.cell_{l}.{ih,hh}.{weight,bias}
  affinity.affinity.{0,2,4,6,8}   -> affinity.dense_{0,1,2,3,out}

The reference's dead modules (cls_mlp, mlp2, gru2, pnnGru, BN step
counters) come back as leftover keys, the same list as the JAX function's.
`export_reference_state_dict` is the inverse (the JAX package's :254).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

_PARAM_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}

# per-scale layer count of each SA level; FP levels have one layer
_SA_LAYERS = {"sa1": 3, "sa2": 2, "sa3": 2}
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
_GRU_LAYERS = 5


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A float32 CPU tensor of arr's own shape (0-d stays 0-d, as the
    model's bin_score; np.ascontiguousarray would make it (1,))."""
    return torch.tensor(np.array(arr, dtype=np.float32, order="C"))


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
            out[name] = _tensor(arr)
    return out


# ---- reference checkpoints -------------------------------------------------
#
# One table of (reference name, port name, kind) drives both directions.
# kind: "conv" a 1x1 Conv2d weight (O, I, 1, 1); "plain" a tensor whose
# shape is the same on both sides (Linear and GRU weights, biases, BN
# vectors); "scalar" bin_score; "bn" a BatchNorm whose
# num_batches_tracked counter the export writes (0, as the JAX export).


def _shared_layer(ref: str, port: str, i: int):
    yield f"{ref}.layer{i}.conv.weight", f"{port}.dense_{i}.weight", "conv"
    for leaf in _BN_LEAVES:
        yield (f"{ref}.layer{i}.bn.bn.{leaf}", f"{port}.bn_{i}.{leaf}",
               "plain")
    yield f"{ref}.layer{i}.bn.bn", None, "bn"


def _pnhead(ref: str, port: str):
    for sa, n_layers in _SA_LAYERS.items():
        for scale in (0, 1):
            for i in range(n_layers):
                yield from _shared_layer(f"{ref}.{sa}.mlps.{scale}",
                                         f"{port}.{sa}.mlp_{scale}", i)
    for i in (1, 2, 3):
        for leaf in ("weight", "bias"):
            yield (f"{ref}.linear{i}.{leaf}", f"{port}.linear{i}.{leaf}",
                   "plain")
    for fp in ("fp1", "fp2", "fp3"):
        yield from _shared_layer(f"{ref}.{fp}.mlp", f"{port}.{fp}.mlp", 0)


def _conv_stack(ref: str, port: str, names):
    for i, name in enumerate(names):
        yield f"{ref}.{i}.weight", f"{port}.{name}.weight", "conv"
        yield f"{ref}.{i}.bias", f"{port}.{name}.bias", "plain"


def _reference_table(n_cost_mlp: int = 3, n_sf_mlp: int = 3):
    """(reference name, port name, kind) for every weight-bearing key of
    the reference Track4D (src/models/track4d.py:25-42), in the order the
    JAX converter reads them."""
    yield from _pnhead("pn_head", "pn_head")
    yield from _conv_stack("fc_layer.mlp_convs", "fc_layer.mlp",
                           [f"dense_{i}" for i in range(n_cost_mlp)])
    for wn in ("weightnet1", "weightnet2"):
        yield from _conv_stack(f"fc_layer.{wn}.mlp_convs", f"fc_layer.{wn}",
                               ["dense_0", "dense_1", "dense_out"])
    yield from _pnhead("fd_layer.mse", "fd_layer.mse")
    for name in ("fp", "cp"):
        for i in range(n_sf_mlp):
            ref = f"fd_layer.{name}.sf_mlp.{i}"
            port = f"fd_layer.{name}.mlp"
            yield f"{ref}.0.weight", f"{port}.dense_{i}.weight", "conv"
            for leaf in _BN_LEAVES:
                yield f"{ref}.1.{leaf}", f"{port}.bn_{i}.{leaf}", "plain"
            yield f"{ref}.1", None, "bn"
    yield "fd_layer.fp.conv2.weight", "fd_layer.fp.out.weight", "conv"
    yield "fd_layer.cp.conv2.weight", "fd_layer.cp.conv_out.weight", "conv"
    for leaf in ("weight", "bias"):
        yield (f"fd_layer.cp.linear.{leaf}", f"fd_layer.cp.linear.{leaf}",
               "plain")
    for l in range(_GRU_LAYERS):
        for gate in ("ih", "hh"):
            for leaf in ("weight", "bias"):
                yield (f"fd_layer.torchGRU.{leaf}_{gate}_l{l}",
                       f"fd_layer.gru.cell_{l}.{gate}.{leaf}", "plain")
    for t_idx, name in zip((0, 2, 4, 6, 8),
                           ("dense_0", "dense_1", "dense_2", "dense_3",
                            "dense_out")):
        for leaf in ("weight", "bias"):
            yield (f"affinity.affinity.{t_idx}.{leaf}",
                   f"affinity.{name}.{leaf}", "plain")
    yield "bin_score", "bin_score", "scalar"


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def convert_reference_state_dict(
        state_dict: Mapping, n_cost_mlp: int = 3,
        n_sf_mlp: int = 3) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """Reference torch Track4D state_dict -> (the port's state_dict as
    float32 CPU tensors, sorted leftover keys). A missing key raises
    KeyError, except bin_score, which the port then keeps as it is."""
    out: Dict[str, torch.Tensor] = {}
    used = set()
    for ref, port, kind in _reference_table(n_cost_mlp, n_sf_mlp):
        if kind == "bn" or (kind == "scalar" and ref not in state_dict):
            continue
        arr = _np(state_dict[ref]).astype(np.float32)
        used.add(ref)
        if kind == "conv":
            arr = arr[:, :, 0, 0]
        elif kind == "scalar":
            arr = arr.reshape(())
        out[port] = _tensor(arr)
    return out, sorted(set(state_dict) - used)


def export_reference_state_dict(state_dict) -> Dict[str, np.ndarray]:
    """The port's state_dict (or a Track4D) -> reference torch state_dict
    with numpy values: the inverse of convert_reference_state_dict, as the
    JAX package's export. BatchNorm `num_batches_tracked` counters are
    written as 0; the reference's dead modules have no counterpart and are
    left out (the reference loads with strict=False)."""
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    out: Dict[str, np.ndarray] = {}
    for ref, port, kind in _reference_table():
        if kind == "bn":
            out[f"{ref}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)
            continue
        if kind == "scalar" and port not in state_dict:
            continue
        arr = _np(state_dict[port])
        if kind == "conv":
            arr = arr[:, :, None, None]
        elif kind == "scalar":
            arr = arr.reshape(())
        out[ref] = arr
    return out


def save_reference_checkpoint(state_dict, path: str) -> None:
    """Write the port's weights as a reference-format torch state_dict
    (`.t7`), loadable by the reference's `load_state_dict(strict=False)`
    and by both packages' `load_reference_checkpoint`."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_reference_state_dict(state_dict).items()}
    torch.save(sd, path)


def load_reference_checkpoint(path: str):
    """Load a reference .t7 / .pt checkpoint file and convert it ->
    (state_dict, leftover keys)."""
    # weights_only=False: torch >= 2.6 defaults to True, which refuses
    # whole-module pickles before the state_dict fallback could run; a
    # reference checkpoint is trusted input here, as in the JAX package
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_reference_state_dict(sd)

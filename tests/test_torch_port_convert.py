"""CPU parity of the port's reference-checkpoint loader
(`ratrack_tpu_torch/utils/convert.py`) against the JAX package's.

A reference state dict, from the reference Track4D's own module tree
(tests/test_convert.py::_TorchTrack4D) or exported by the JAX package from
its variables, goes through the port's loader and through the JAX
converter composed with `from_flax_variables`: the tensors are identical,
and so are the leftover keys. The port's export round-trips through the
JAX converter to the same variables. All exact.
"""

import numpy as np
import pytest
import torch

from ratrack_tpu.utils import convert as jconvert
from ratrack_tpu_torch.models import Track4D
from ratrack_tpu_torch.train.checkpoint import is_train_checkpoint
from ratrack_tpu_torch.utils import (convert_reference_state_dict,
                                     export_reference_state_dict,
                                     from_flax_variables,
                                     load_reference_checkpoint,
                                     save_reference_checkpoint)
from test_convert import _randomize_bn_stats, _TorchTrack4D


def _reference_sd(seed):
    torch.manual_seed(seed)
    model = _TorchTrack4D()
    _randomize_bn_stats(model, np.random.RandomState(seed))
    return model


def _via_jax(sd):
    variables, leftover = jconvert.convert_reference_state_dict(sd)
    return from_flax_variables(variables), leftover


def assert_same_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == torch.float32, k
        assert got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_module_state_dict_converts_as_the_jax_route(seed):
    sd = _reference_sd(seed).state_dict()
    got, leftover = convert_reference_state_dict(sd)
    want, jleftover = _via_jax(sd)
    assert_same_state(got, want)
    assert leftover == jleftover and leftover
    assert all(k.startswith(("fc_layer.cls_mlp", "fd_layer.mlp2",
                             "fd_layer.gru2", "fd_layer.pnnGru"))
               or k.endswith("num_batches_tracked") for k in leftover)
    # the port's Track4D takes it as it is, strictly
    model = Track4D(npoint=64, k_max=4, device="cpu")
    model.load_state_dict(got)
    assert_same_state({k: v for k, v in model.state_dict().items()}, got)


def test_jax_exported_state_dict_converts_as_the_jax_route(tmp_path):
    """JAX variables (random, BN statistics included) -> the JAX export
    -> both loaders, in memory and from a `.t7` file."""
    variables, _ = jconvert.convert_reference_state_dict(
        _reference_sd(3).state_dict())
    sd = jconvert.export_reference_state_dict(variables)
    got, leftover = convert_reference_state_dict(sd)
    want, jleftover = _via_jax(sd)
    assert_same_state(got, want)
    assert_same_state(got, from_flax_variables(variables))
    assert leftover == jleftover == sorted(
        k for k in sd if k.endswith("num_batches_tracked"))
    path = str(tmp_path / "model.t7")
    jconvert.save_reference_checkpoint(variables, path)
    got_file, leftover_file = load_reference_checkpoint(path)
    jvars, jleft_file = jconvert.load_reference_checkpoint(path)
    assert_same_state(got_file, from_flax_variables(jvars))
    assert leftover_file == jleft_file
    assert not is_train_checkpoint(path)


def test_whole_module_pickle_loads(tmp_path):
    """A checkpoint that pickles the whole reference module (trusted
    input; weights_only=False, as the JAX loader)."""
    model = _reference_sd(4)
    path = str(tmp_path / "module.t7")
    torch.save(model, path)
    got, leftover = load_reference_checkpoint(path)
    want, jleftover = _via_jax(model.state_dict())
    assert_same_state(got, want)
    assert leftover == jleftover
    assert not is_train_checkpoint(path)


def test_port_export_round_trips_through_the_jax_converter(tmp_path):
    torch.manual_seed(5)
    model = Track4D(npoint=64, k_max=4, device="cpu",
                    generator=torch.Generator().manual_seed(5))
    for name, buf in model.named_buffers():
        buf.copy_(torch.rand_like(buf) + (0.5 if "var" in name else 0.0))
    own = model.state_dict()
    sd = export_reference_state_dict(model)
    # the same keys, shapes and values as the JAX export of the same weights
    variables, _ = jconvert.convert_reference_state_dict(sd)
    jsd = jconvert.export_reference_state_dict(variables)
    assert sorted(sd) == sorted(jsd)
    for k in jsd:
        np.testing.assert_array_equal(np.asarray(sd[k]), np.asarray(jsd[k]),
                                      err_msg=k)
        assert np.asarray(sd[k]).shape == np.asarray(jsd[k]).shape, k
    assert_same_state(from_flax_variables(variables), own)
    # and through files, both directions
    path = str(tmp_path / "port.t7")
    save_reference_checkpoint(own, path)
    jvars, jleft = jconvert.load_reference_checkpoint(path)
    assert_same_state(from_flax_variables(jvars), own)
    got, left = load_reference_checkpoint(path)
    assert_same_state(got, own)
    assert left == jleft


def test_is_train_checkpoint_tells_the_two_kinds_apart(tmp_path):
    from ratrack_tpu_torch.train import (TrainConfig, create_train_state,
                                         latest_exists, save_train_state)
    model = Track4D(npoint=64, k_max=4, device="cpu")
    assert not latest_exists(str(tmp_path), "best")
    save_train_state(str(tmp_path), "best", create_train_state(
        model, TrainConfig(), steps_per_epoch=1, device="cpu"))
    assert latest_exists(str(tmp_path), "best")
    assert is_train_checkpoint(str(tmp_path / "best.pt"))
    save_reference_checkpoint(model.state_dict(), str(tmp_path / "ref.pt"))
    assert not is_train_checkpoint(str(tmp_path / "ref.pt"))

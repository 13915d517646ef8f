"""The device the package's entry points run on.

The port runs on the card. `Track4D`, `init_state`, `to_tensors` and
`create_train_state` take `device=None` to mean `default_device()`; a caller
that wants the CPU (the parity tests, a CPU yardstick) says `device="cpu"`.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The CUDA device. Raises where there is none: nothing falls back to
    the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ratrack_tpu_torch runs on a CUDA device and none is available; "
            "pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """`device`, or `default_device()` for None."""
    return default_device() if device is None else torch.device(device)

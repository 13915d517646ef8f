"""RaTrack in PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The port of `ratrack_tpu` (JAX/Flax/Pallas), which stays in the repository
as the reference every module here is tested against. The layout mirrors
it module for module:

ops/       point ops (ball query, kNN, 3-NN interpolation, gathers, farthest
           point sampling, the Morton sort) and the kernel wrappers: eval
           fused_sa (SA pair, SA scale), fused_fp (3-NN interpolation),
           fused_correlator (cost volume, and its split form over given
           indices); train fused_sa_train (pair and scale),
           fused_correlator_train (forward + backward); stretch fused_knn
           (tiled kNN), sampling (farthest point sampling),
           fused_sinkhorn.
csrc/      the CUDA C++ sources of those kernels (sm_90a).
kernels/   nvcc build + ctypes loading of csrc/ into one shared library;
           seeded kernel cases for the card checks.
models/    nn.Modules: PNHead, FeatureCorrelator, FlowDecoder, predictors,
           Affinity, Track4D (eval by default, `train()` for training).
tracker/   DBSCAN, log-Sinkhorn with dustbin (and its early exit),
           association (match structure, id inheritance), track state.
train/     the eval steps and scans (cached backbone or not, and the
           pipelined step over a whole block), losses, Adam + StepLR,
           the per-frame train steps, train checkpoints.
serve.py   RadarTracker: online multi-stream serving over the eval step.
config.py  the YAML configuration (the JAX package's keys).
main.py    the train / eval CLI (`python -m ratrack_tpu_torch.main`).
data/      FrameBatch, the synthetic clip generator, and the VoD layer:
           file readers, calibration and poses, GT boxes, the native
           loader, the record pipeline and a fixture tree (numpy).
eval/      result export, MOT metrics, the Kalman re-tracker and VoD
           detection AP, with their CLIs `eval.run`, `eval.run_kf` and
           `eval.run_ap` (numpy and scipy, no tensor work).
utils/     weight conversion: flax variables and the reference's torch
           checkpoints to and from the port's state_dict.

Tensors are points-major with a written-out stream dimension:
(B, N, C). This package never imports JAX. Its entry points (`Track4D`,
`init_state`, `to_tensors`, `create_train_state`, `model_from_config`,
`RadarTracker.from_checkpoint`) run on the CUDA device
unless the caller passes `device="cpu"`; `default_device()` raises where
there is no card.
"""

from .device import default_device

__all__ = ["default_device"]
__version__ = "0.1.0"

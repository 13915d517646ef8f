"""The plain reference of RaTrack that decides a run's `correct`.

Plain PyTorch in float32, written from the published model and the JAX
package's semantics, frozen with the benchmark: it imports nothing of the
program under test (`ratrack_tpu_torch`), nor JAX, and takes nothing the
program made. Its modules carry the program's parameter names, so one
seeded state dict (perfbench/weights.py) loads into both.

  ops.py      neighbourhoods, sampling, gathers, interpolation
  model.py    PointNet++ heads, correlator, decoder, GRU, affinity, Track4D
  tracker.py  DBSCAN, descriptors, GT match, Sinkhorn, id inheritance
  losses.py   the training loss
  control.py  the TF32 control: every matrix product on TF32 operands
"""

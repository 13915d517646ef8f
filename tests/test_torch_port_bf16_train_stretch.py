"""CPU parity of the bfloat16 train step at 8192 points (one stream, one
frame): the port against the JAX package's unfused bfloat16 step.

Above 1024 points the JAX train path leaves its fused train kernels
(models/pnhead.py:103-106, models/correlator.py:141-143: the TPU kernels'
fast-memory limit) and runs its unfused XLA stack with bfloat16 Dense
layers; the port runs B9 / B10 at every size, float32 inside, as at 512
points (ROADMAP: a standing departure). Model: Track4D(npoint=128,
exact_fps=True, mov_budget=64) over 8192 points, full widths, the
gates of tests/test_torch_port_bf16_train.py::assert_step_like_jax_bf16
(loss items within 2e-2; the gradient and the running statistics held to
the JAX float32 step by twice the JAX bfloat16 step's distance).
Measured: loss items within 2.5e-4 relative; the gradient 0.44 of |G|
from float32, JAX's bfloat16 0.55, cosine 0.905 / 0.838; the worst leaf
at 0.56 of its bound. The weights' seed is one whose cls stays below
bfloat16's last step under 1: with seed 121 one negative point's cls
rounds to 1.0, and both packages give a SegLoss of the largest float and
a NaN gradient (the reference behaviour that
test_torch_port_bf16_train.py::test_saturated_bf16_loss_matches_jax
pins), which no norm can compare.
"""

from test_torch_port_bf16_train import (_port, _port_frames, _world,
                                        assert_step_like_jax_bf16,
                                        first_step, jax_bf16_and_f32)
from ratrack_tpu_torch.tracker import init_state
from ratrack_tpu_torch.train import make_train_step

N_STRETCH, NPOINT, BUDGET, K = 8192, 128, 64, 8


def test_train_step_at_8192_points_matches_jax_unfused_bf16(monkeypatch):
    models, v, frames, kw = _world(1, N_STRETCH, 1, 120, npoint=NPOINT,
                                   exact_fps=True, mov_budget=BUDGET)
    jax_bf16, jax_f32 = jax_bf16_and_f32(monkeypatch, models, v, frames,
                                         False, 1)
    ts = _port(v, kw)
    _, got = make_train_step(ts)(init_state(1, K, device="cpu"),
                                 _port_frames(frames, 0), False)
    assert_step_like_jax_bf16(ts, got, first_step(jax_bf16),
                              first_step(jax_f32), "8192-point step")

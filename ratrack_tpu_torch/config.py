"""Configuration: YAML -> frozen dataclass.

The port's own copy of `ratrack_tpu/config.py` (the port imports nothing
of the JAX package), field for field and default for default, so that the
same `configs/*.yaml` drive both; tests/test_torch_port_serve.py holds the
two equal. It mirrors the reference's YAML -> EasyDict flow
(`src/utils/parser_util.py:4-39`, `src/configs.yaml`) with the same key
names, plus the padded-shape keys (point budget, track slots).

Keys the port does not implement yet are kept so that every config loads;
`models.track4d.model_from_config` raises on a value it cannot honour
(`fused_sa: false` on the card). `dtype` is "float32" or "bfloat16" (the
two the JAX model_from_config tells apart, track4d.py:235); any other value
raises here.
`yaml` is imported inside `load_config` only: building a `Config` by hand
needs no YAML package.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class Config:
    # experiment (reference: src/configs.yaml)
    exp_name: str = "track4d_radar"
    model: str = "track4d_radar"
    num_points: int = 256          # kept for reference-key compatibility
    batch_size: int = 1
    epochs: int = 8
    lr: float = 1e-3
    weight_decay: float = 1e-10    # Adam weight_decay (main.py:61)
    decay_epochs: int = 1
    decay_rate: float = 0.97
    pretrain_epochs: int = 2
    seed: int = 1234
    num_workers: int = 0

    # dataset
    eval: bool = False
    dataset: str = "vod"
    dataset_path: str = ""
    clips_dir: str = ""            # defaults to <repo>/configs/clips
    npoints: int = 512             # SA layer npoint (model_utils.py:397-399)
    min_obj_points: int = 2
    rigid_thres: float = 0.15      # parsed but unused, as in reference

    # checkpoints
    load_checkpoint: bool = False
    model_path: str = ""
    continue_model: bool = False
    checkpoints_dir: str = "checkpoints"
    results_dir: str = "results"

    # --- padded-shape and device keys (no reference equivalent) ---
    n_max: int = 512               # padded point budget per frame
    k_max: int = 32                # track/cluster slots per frame
    g_max: int = 32                # GT object slots per frame
    exact_fps: bool = False        # True: run true FPS even when npoint==n_max
    fused_sa: bool = True          # False: the JAX package's unfused path (the port raises on the card)
    dbscan_eps: float = 1.5        # track4d.py:36
    dbscan_max_iters: int = 64
    sinkhorn_iters: int = 500      # track4d.py:167
    sinkhorn_tol: float = 0.0      # >0: convergence early-exit (perf opt-in)
    sinkhorn_alpha: float = 0.9
    match_conf_thres: float = 0.01  # track4d.py:146
    mov_thres: float = 0.5         # track4d.py:56
    mov_budget: int = 0            # >0: DBSCAN over top-K moving pts only
    gru_layers: int = 5            # model_utils.py:279
    feat_dim: int = 128
    dtype: str = "float32"         # compute dtype: float32 | bfloat16 (eval)
    dp: int = 1                    # data-parallel mesh size (clips axis)
    scan_frames: int = 0           # >0: scan over this many frames/step
    prefetch_depth: int = 4        # host-side block prefetch queue depth
    synth_clips: int = 4           # synthetic dataset: number of clips
    synth_frames: int = 6          # synthetic dataset: frames per clip
    profile_dir: str = ""          # non-empty: dump a profiler trace here
    vis_dir: str = ""              # non-empty: eval renders BEV PNGs here

    def __post_init__(self) -> None:
        if self.dtype not in DTYPES:
            raise ValueError(f"dtype {self.dtype!r}: one of {DTYPES}")

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


def load_config(path: str | Path, **overrides: Any) -> Config:
    """Load YAML into Config; unknown keys are ignored with a warning."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    raw.update(overrides)
    fields = {f.name for f in dataclasses.fields(Config)}
    known = {k: v for k, v in raw.items() if k in fields}
    unknown = sorted(set(raw) - fields)
    if unknown:
        import warnings
        warnings.warn(f"config: ignoring unknown keys {unknown}")
    return Config(**known)

"""Track4D: the radar moving-object tracking network, batched over
streams. Counterpart of `ratrack_tpu/models/track4d.py`.

Per-point feature tensor F (B, N, 139) = [warp 3 | pc1 3 | flow 3 |
RCS, v_r 2 | prop 128]. Clustering features are F[..., 3:9] u F[..., 10:12]:
the reference indexes 10:12 (v_r plus the first prop channel), a quirk kept
for parity. `bin_score` is registered and never used, as in the reference
(the association passes the constant 0.9).

The module is built for eval (requires_grad off, `eval()`);
`train.step.create_train_state` turns it to training. In train mode both
heads are recomputed every frame (`step_cached` is eval only), batch norm
takes batch statistics, and the kernels are the train kernels B9 / B10.
No gradient reaches the loss through DBSCAN labels, track ids or the
Sinkhorn association: their inputs are detached (the Sinkhorn's in
`tracker.association.match_structure`), so autograd records none of the
500 Sinkhorn iterations. The object descriptors stay differentiable
(the affinity loss reaches the decoder through them); the recurrent state
carried to the next frame (GRU state, descriptors) is detached
(track4d.py:208, step.py:116-118).

Stretch options, as the JAX module's: `exact_fps` (true farthest point
sampling in both PNHeads, kernel B6), `mov_budget` (DBSCAN over the
`mov_budget` moving points of highest score where the cloud is larger,
track4d.py:137-143) and `sinkhorn_kernel` (the Sinkhorn iterations in
kernel B7; off by default, as tracker/sinkhorn.py:33 of the JAX package).
Clouds above 4096 points take the split correlator (kernels B5 and B4).
`sinkhorn_tol` > 0 stops each stream's Sinkhorn iterations early
(tracker/sinkhorn.py, an eager loop); B7 has no early exit, so
`sinkhorn_kernel` with `sinkhorn_tol` > 0 raises.

The per-frame step splits into stages that depend on no earlier frame
(`frame_stage`, `output_stage`, `affinity_stage`, and
`tracker.association.match_structure`), which the pipelined eval step
runs over all frames of a block at once, and the two serial carries
(`gru_stage`, `tracker.association.assign_ids`).

The parameters live on `device`; None means the card
(`device.default_device()`, which raises where there is none).

`dtype` is the compute dtype (float32 or bfloat16), the JAX module's
`dtype`: parameters and the tracking state stay float32, the layers compute
in `dtype` and the eval kernels take it as their operand type. In
bfloat16 cls, flow and the affinities are bfloat16 and the 139-channel
`feats` float32 (track4d.py:133); DBSCAN, the descriptors and the Sinkhorn
run in float32. In training the train kernels B8-B10 run in float32 behind
casts (they take no compute dtype, nor do the JAX ones), and the
gradients reach the float32 parameters in float32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..data.frames import FrameBatch
from ..device import resolve_device
from ..trace import span
from ..tracker.association import (associate, cluster_descriptors,
                                   greedy_gt_match)
from ..tracker.dbscan import compact_dbscan, dbscan
from ..tracker.state import TrackState, init_state, reset_where
from .affinity import Affinity
from .correlator import FeatureCorrelator
from .decoder import FlowDecoder, masked_max
from .layers import init_parameters
from .pnhead import PNHead

# config `dtype` -> the compute dtype (JAX model_from_config, :235)
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Track4D(nn.Module):
    def __init__(self, npoint: int = 512, k_max: int = 32,
                 feat_dim: int = 128, gru_layers: int = 5,
                 min_obj_points: int = 2, dbscan_eps: float = 1.5,
                 dbscan_max_iters: int = 64, sinkhorn_iters: int = 500,
                 sinkhorn_tol: float = 0.0, sinkhorn_alpha: float = 0.9,
                 match_conf_thres: float = 0.01, mov_thres: float = 0.5,
                 mov_budget: int = 0, exact_fps: bool = False,
                 sinkhorn_kernel: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if dtype not in COMPUTE_DTYPES.values():
            raise ValueError(f"dtype {dtype}: float32 or bfloat16")
        if sinkhorn_kernel and sinkhorn_tol > 0:
            raise ValueError(
                f"sinkhorn_kernel with sinkhorn_tol={sinkhorn_tol}: kernel "
                f"B7 runs all sinkhorn_iters iterations, it has no early exit")
        device = resolve_device(device)
        self.npoint, self.k_max = npoint, k_max
        self.feat_dim, self.gru_layers = feat_dim, gru_layers
        self.min_obj_points = min_obj_points
        self.dbscan_eps, self.dbscan_max_iters = dbscan_eps, dbscan_max_iters
        self.sinkhorn_iters, self.sinkhorn_alpha = sinkhorn_iters, sinkhorn_alpha
        self.sinkhorn_tol = sinkhorn_tol
        self.match_conf_thres, self.mov_thres = match_conf_thres, mov_thres
        self.mov_budget, self.sinkhorn_kernel = mov_budget, sinkhorn_kernel
        self.dtype = dtype
        self.pn_head = PNHead(npoint, 2, exact_fps, dtype=dtype)
        self.fc_layer = FeatureCorrelator(16, (256, 256, 256), dtype=dtype)
        self.fd_layer = FlowDecoder(npoint, feat_dim, gru_layers, exact_fps,
                                    dtype=dtype)
        self.affinity = Affinity(141, dtype=dtype)
        self.bin_score = nn.Parameter(torch.ones(()))
        if generator is not None:
            init_parameters(self, generator)
        self.requires_grad_(False)
        self.eval()
        self.to(device)

    @span("head")
    def head_stage(self, pc, ft, mask) -> torch.Tensor:
        """One cloud through the PNHead -> (B, N, 128). In eval this is a
        pure function of the cloud, so the eval scan carries frame t's result
        forward as frame t+1's pc2 head."""
        return self.pn_head(pc, ft, mask)[1]

    def _frame_stage_from_heads(self, frame: FrameBatch, f1, f2):
        m1, m2 = frame.mask1, frame.mask2
        with span("cost_volume"):
            f1 = torch.cat([f1, masked_max(f1, m1).unsqueeze(1)
                            .expand_as(f1)], dim=-1)    # (B, N, 256)
            f2 = torch.cat([f2, masked_max(f2, m2).unsqueeze(1)
                            .expand_as(f2)], dim=-1)
            cor = self.fc_layer(frame.pc1, frame.pc2, f1, f2, m1, m2)
        return self.fd_layer.pre_gru(frame.pc1, frame.ft1, f1, cor, m1)

    def frame_stage(self, frame: FrameBatch):
        """Everything before the GRU, both heads included -> (cls (B, N),
        prop (B, N, 128), gfeat_in (B, 128)) (track4d.py:114-119)."""
        f1 = self.head_stage(frame.pc1, frame.ft1, frame.mask1)
        f2 = self.head_stage(frame.pc2, frame.ft2, frame.mask2)
        return self._frame_stage_from_heads(frame, f1, f2)

    def gru_stage(self, gfeat_in, h):
        """One GRU step, the decoder's only dependency on earlier frames:
        (B, 128), (B, layers, 128) -> (gfeat_out, h_new)."""
        return self.fd_layer.gru_apply(gfeat_in, h)

    def output_stage(self, frame: FrameBatch, cls, prop, gfeat_out,
                     frame_idx):
        """Flow, clustering, descriptors and GT match for one frame."""
        flow = self.fd_layer.post_gru(prop, gfeat_out, frame.mask1)
        with span("dbscan"):
            warp = frame.pc1 + flow
            # float32 in bfloat16 too (track4d.py:133): cat promotes to warp's
            feats = torch.cat([warp, frame.pc1, flow, frame.ft1, prop],
                              dim=-1)
            mov = (cls > self.mov_thres) & frame.mask1
            db_in = torch.cat([feats[..., 3:9], feats[..., 10:12]],
                              dim=-1).detach()
            if 0 < self.mov_budget < db_in.shape[1]:
                labels = compact_dbscan(db_in, mov, cls.detach(),
                                        self.mov_budget, self.dbscan_eps,
                                        self.min_obj_points,
                                        self.dbscan_max_iters)
            else:
                labels = dbscan(db_in, mov, self.dbscan_eps,
                                self.min_obj_points, self.dbscan_max_iters)
            labels = torch.where(labels < self.k_max, labels,
                                 torch.full_like(labels, -1))
        desc, curr_valid, sizes, _ = cluster_descriptors(feats, labels,
                                                         self.k_max)
        curr_gt = greedy_gt_match(labels, frame.gt_dense, frame.gt_label_ids,
                                  frame.gt_valid, self.k_max, frame_idx)
        return dict(flow=flow, warp=warp, feats=feats, labels=labels,
                    desc=desc, curr_valid=curr_valid, sizes=sizes,
                    curr_gt=curr_gt,
                    n=curr_valid.sum(dim=1).to(torch.int32))

    @span("affinity")
    def affinity_stage(self, desc_prev, desc_curr) -> torch.Tensor:
        """(B, K_prev, K_curr) affinity on descriptor differences."""
        return self.affinity(desc_curr.unsqueeze(1) - desc_prev.unsqueeze(2))

    def forward(self, frame: FrameBatch, state: TrackState
                ) -> Tuple[Dict[str, torch.Tensor], TrackState]:
        f1 = self.head_stage(frame.pc1, frame.ft1, frame.mask1)
        f2 = self.head_stage(frame.pc2, frame.ft2, frame.mask2)
        return self._step_from_heads(frame, state, f1, f2)

    def step_cached(self, frame: FrameBatch, state: TrackState, f2_local):
        """Full step with the pc2 head carried from the previous frame;
        valid when pc2 is the previous frame's pc1 and the head is fixed
        (eval). Returns (outputs, new_state, f1_local) so f1 becomes the
        next f2."""
        if self.training:
            raise RuntimeError("step_cached is eval only: in training the "
                               "pc2 head changes with every update")
        f1 = self.head_stage(frame.pc1, frame.ft1, frame.mask1)
        out, new_state = self._step_from_heads(frame, state, f1, f2_local)
        return out, new_state, f1

    def _step_from_heads(self, frame: FrameBatch, state: TrackState, f1, f2):
        b = frame.pc1.shape[0]
        fresh = init_state(b, self.k_max, self.gru_layers, self.feat_dim,
                           device=frame.pc1.device, dtype=state.h.dtype)
        state = reset_where(frame.new_seq, state, fresh)
        cls, prop, gfeat_in = self._frame_stage_from_heads(frame, f1, f2)
        gfeat_out, h_new = self.gru_stage(gfeat_in, state.h)
        o = self.output_stage(frame, cls, prop, gfeat_out, state.frame_idx)
        m = state.valid.sum(dim=1).to(torch.int32)
        aff = self.affinity_stage(state.desc, o["desc"])
        res = associate(aff, m, o["n"], state.track_id,
                        state.next_id, self.sinkhorn_alpha,
                        self.sinkhorn_iters, self.match_conf_thres,
                        self.sinkhorn_kernel, self.sinkhorn_tol)
        new_state = TrackState(
            h=h_new.detach(), desc=o["desc"].detach(), valid=o["curr_valid"],
            track_id=res.track_id, gt_id=o["curr_gt"], next_id=res.next_id,
            frame_idx=state.frame_idx + 1)
        outputs = dict(
            flow=o["flow"], warp=o["warp"], cls=cls, feats=o["feats"],
            labels=o["labels"], track_id=res.track_id, conf=res.conf,
            aff=aff, m=m, n=o["n"], sizes=o["sizes"],
            prev_gt_id=state.gt_id, prev_valid=state.valid,
            curr_gt_id=o["curr_gt"], curr_valid=o["curr_valid"])
        return outputs, new_state


def model_from_config(cfg, *, sinkhorn_kernel: bool = False,
                      generator: torch.Generator | None = None,
                      device=None):
    """Track4D from a `config.Config` (JAX `model_from_config`,
    track4d.py:225-236); `sinkhorn_tol` is the early exit.
    `sinkhorn_kernel` is no config key (the JAX package switches it with a
    module global). `fused_sa: false` (the JAX package's unfused eval path)
    holds on the CPU, where every wrapper takes its plain version; on the
    card the port always runs its kernels, so there it raises. `dtype`:
    "float32" or "bfloat16" (config.Config refuses any other).

    `model: flot` builds FLOT (models/flot.py) instead, at its published
    settings (the `FLOT` constructor's defaults), in float32 only."""
    device = resolve_device(device)
    if cfg.model == "flot":
        from .flot import FLOT
        if cfg.dtype != "float32":
            raise NotImplementedError(f"FLOT runs in float32; got dtype "
                                      f"{cfg.dtype!r}")
        return FLOT(generator=generator, device=device)
    if not cfg.fused_sa and device.type != "cpu":
        raise NotImplementedError(
            f"fused_sa=False on {device}: the port has no switch to its "
            f"plain versions; on the card it always runs its kernels")
    return Track4D(
        npoint=cfg.npoints, k_max=cfg.k_max, feat_dim=cfg.feat_dim,
        gru_layers=cfg.gru_layers, min_obj_points=cfg.min_obj_points,
        dbscan_eps=cfg.dbscan_eps, dbscan_max_iters=cfg.dbscan_max_iters,
        sinkhorn_iters=cfg.sinkhorn_iters, sinkhorn_tol=cfg.sinkhorn_tol,
        sinkhorn_alpha=cfg.sinkhorn_alpha,
        match_conf_thres=cfg.match_conf_thres, mov_thres=cfg.mov_thres,
        mov_budget=cfg.mov_budget, exact_fps=cfg.exact_fps,
        sinkhorn_kernel=sinkhorn_kernel, dtype=COMPUTE_DTYPES[cfg.dtype],
        generator=generator, device=device)

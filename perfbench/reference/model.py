"""RaTrack's Track4D as plain PyTorch modules, batched over streams.

The published architecture (RaTrack, ICRA 2024: a PointNet++-MSG head per
cloud, a cost-volume correlator, a flow decoder with a 5-layer GRU, motion
segmentation, DBSCAN, object descriptors, an affinity MLP and Sinkhorn
association), in the JAX package's semantics:

  * batch norm in training takes its moments per stream; the running
    averages move by the mean over streams of the per-stream updates.
    Inside a set-abstraction level the moments run over all centers and
    slots, the variance as max(E[x^2] - mu^2, 0) and the running variance
    with the count npoint * nsample; elsewhere the moments are masked and
    two-pass;
  * a center's slots past its ball query's hits repeat the first hit;
  * the correlator's kNN and every selection follow ops.py;
  * in training no gradient passes DBSCAN, the association or the state
    carried to the next frame.

Every layer is computed as written: no folded batch norm, no factorised
first layer, no cache of the pc2 head (the reference recomputes both heads
every frame). The module names and parameter shapes are the program's, so
one state dict loads into both.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from . import ops
from .tracker import (associate, cluster_descriptors, compact_dbscan, dbscan,
                      greedy_gt_match)

DESC_DIM = 141


class BatchNorm(nn.Module):
    """Batch norm over the last axis (parameter names as the program's)."""

    MOMENTUM = 0.1

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def normalise(self, x, mean, var):
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias

    @torch.no_grad()
    def update(self, mean, var, count):
        """Running averages from per-stream moments mean, var (B, C) over
        count rows (a number or (B,))."""
        count = torch.as_tensor(count, dtype=torch.float32,
                                device=mean.device)
        count = count.reshape(-1, 1) if count.dim() else count
        unbias = count / torch.clamp_min(count - 1.0, 1.0)
        mo = self.MOMENTUM
        self.running_mean.copy_(((1 - mo) * self.running_mean
                                 + mo * mean.detach()).mean(dim=0))
        self.running_var.copy_(((1 - mo) * self.running_var
                                + mo * var.detach() * unbias).mean(dim=0))

    def forward(self, x, mask=None):
        """x (B, ..., C); mask (B, ...) or None: the rows of the moments."""
        if not self.training:
            return self.normalise(x, self.running_mean, self.running_var)
        red = tuple(range(1, x.dim() - 1))
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        if mask is None:
            count = torch.full((x.shape[0],), float(x[0, ..., 0].numel()),
                               device=x.device)
            mean = x.mean(dim=red)
            var = torch.square(x - mean.reshape(shape)).mean(dim=red)
        else:
            m = mask.to(x.dtype).unsqueeze(-1)
            count = torch.clamp_min(m.sum(dim=red)[:, 0], 1.0)
            mean = (x * m).sum(dim=red) / count[:, None]
            var = (torch.square(x - mean.reshape(shape)) * m).sum(
                dim=red) / count[:, None]
        self.update(mean, var, count)
        return self.normalise(x, mean.reshape(shape), var.reshape(shape))


class MLP(nn.Module):
    """Linear (+ batch norm) + activation per layer; a linear layer
    followed by batch norm has no bias."""

    def __init__(self, c_in, widths, bn=True, act="relu"):
        super().__init__()
        self.widths, self.bn, self.act = tuple(widths), bn, act
        prev = c_in
        for i, w in enumerate(self.widths):
            self.add_module(f"dense_{i}", nn.Linear(prev, w, bias=not bn))
            if bn:
                self.add_module(f"bn_{i}", BatchNorm(w))
            prev = w

    def layer(self, i):
        return getattr(self, f"dense_{i}")

    def activate(self, x):
        return torch.relu(x) if self.act == "relu" else F.leaky_relu(x, 0.1)

    def forward(self, x, mask=None):
        for i in range(len(self.widths)):
            x = self.layer(i)(x)
            if self.bn:
                x = getattr(self, f"bn_{i}")(x, mask)
            x = self.activate(x)
        return x


class WeightNet(nn.Module):
    def __init__(self, out_dim, hidden=(8, 8)):
        super().__init__()
        self.dense_0 = nn.Linear(3, hidden[0])
        self.dense_1 = nn.Linear(hidden[0], hidden[1])
        self.dense_out = nn.Linear(hidden[1], out_dim)

    def forward(self, d):
        d = torch.relu(self.dense_0(d))
        d = torch.relu(self.dense_1(d))
        return torch.relu(self.dense_out(d))


class SetAbstraction(nn.Module):
    """One multi-scale-grouping level: per scale a ball query, the shared
    MLP over [x_j - c_i, f_j] and the max over the slots."""

    def __init__(self, npoint, radii, nsamples, mlps, c_in, exact_fps):
        super().__init__()
        self.npoint, self.exact_fps = npoint, exact_fps
        self.radii, self.nsamples = radii, nsamples
        for s, widths in enumerate(mlps):
            self.add_module(f"mlp_{s}", MLP(c_in, widths))

    def forward(self, xyz, feats, mask):
        n = xyz.shape[1]
        if self.npoint == n and not self.exact_fps:
            if mask is None:
                centers = xyz
            else:
                centers = ops.gather(xyz, ops.identity_sample(n, n, mask))
        else:
            centers = ops.gather(xyz, ops.farthest_point_sample(
                xyz.detach(), self.npoint, mask))
        outs = []
        for s, (r, ns) in enumerate(zip(self.radii, self.nsamples)):
            idx = ops.ball_query(r, ns, xyz, centers, mask)
            x = ops.group(xyz, idx) - centers.unsqueeze(2)
            if feats is not None:
                x = torch.cat([x, ops.group(feats, idx)], dim=-1)
            mlp = getattr(self, f"mlp_{s}")
            outs.append(self._mlp(mlp, x, ns).amax(dim=2))
        return centers, torch.cat(outs, dim=-1)

    def _mlp(self, mlp, x, ns):
        if not self.training:
            return mlp(x)
        for i in range(len(mlp.widths)):
            x = mlp.layer(i)(x)
            bn = getattr(mlp, f"bn_{i}")
            mu = x.mean(dim=(1, 2))
            var = torch.clamp_min((x * x).mean(dim=(1, 2)) - mu * mu, 0.0)
            bn.update(mu, var, self.npoint * ns)
            x = torch.relu(bn.normalise(x, mu[:, None, None],
                                        var[:, None, None]))
        return x


class FeaturePropagation(nn.Module):
    def __init__(self, c_in, widths):
        super().__init__()
        self.mlp = MLP(c_in, widths)

    def forward(self, unknown, known, unknown_feats, known_feats, mask=None):
        x = ops.three_interpolate(unknown, known, known_feats)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], dim=-1)
        return self.mlp(x, mask)


class PNHead(nn.Module):
    """3 set-abstraction levels and 3 propagation levels -> 128 a point."""

    def __init__(self, npoint, c_feat, exact_fps):
        super().__init__()
        self.sa1 = SetAbstraction(npoint, (2.0, 4.0), (4, 8),
                                  ((16, 16, 32), (16, 16, 32)), 3 + c_feat,
                                  exact_fps)
        self.sa2 = SetAbstraction(npoint, (4.0, 8.0), (8, 16),
                                  ((32, 32), (32, 64)), 3 + 32, exact_fps)
        self.sa3 = SetAbstraction(npoint, (8.0, 16.0), (16, 32),
                                  ((64, 64), (64, 64)), 3 + 64, exact_fps)
        self.linear1 = nn.Linear(64, 32)
        self.linear2 = nn.Linear(96, 64)
        self.linear3 = nn.Linear(128, 64)
        self.fp3 = FeaturePropagation(128, (128,))
        self.fp2 = FeaturePropagation(160, (128,))
        self.fp1 = FeaturePropagation(128, (128,))

    def forward(self, xyz, feats, mask):
        l1_xyz, l1 = self.sa1(xyz, feats, mask)
        l1 = self.linear1(l1)
        l2_xyz, l2 = self.sa2(l1_xyz, l1, None)
        l2 = self.linear2(l2)
        l3_xyz, l3 = self.sa3(l2_xyz, l2, None)
        l3 = self.linear3(l3)
        l2 = self.fp3(l2_xyz, l3_xyz, l2, l3)
        l1 = self.fp2(l1_xyz, l2_xyz, l1, l2)
        return self.fp1(xyz, l1_xyz, None, l1, mask)


class Correlator(nn.Module):
    """Cost volume: stage 1 the MLP over [f1_i, f2_j, x_j - x_i] of pc1's
    16 nearest points of pc2, weighted by WeightNet1(x_j - x_i) and summed;
    stage 2 the stage-1 cost of pc1's 16 nearest points of pc1, weighted
    by WeightNet2 and summed. Above SPLIT_ABOVE points a tie among equal
    distances goes to the lowest index along the clouds' Z-curves, as the
    JAX package's split correlator sorts them (models/correlator.py)."""

    SPLIT_ABOVE = 4096

    def __init__(self, k=16, widths=(256, 256, 256), c=256):
        super().__init__()
        self.k = k
        self.mlp = MLP(2 * c + 3, widths, bn=False, act="leaky")
        self.weightnet1 = WeightNet(widths[-1])
        self.weightnet2 = WeightNet(widths[-1])

    def select(self, query, qmask, points, pmask):
        if query.shape[1] > self.SPLIT_ABOVE:
            return ops.knn_sorted(self.k, query, qmask, points, pmask)
        return ops.knn(self.k, query, points, pmask)[1]

    def forward(self, pc1, pc2, f1, f2, mask1, mask2):
        idx = self.select(pc1, mask1, pc2, mask2)
        dirs = ops.group(pc2, idx) - pc1.unsqueeze(2)
        x = torch.cat([f1.unsqueeze(2).expand(-1, -1, self.k, -1),
                       ops.group(f2, idx), dirs], dim=-1)
        cost = torch.sum(self.weightnet1(dirs) * self.mlp(x), dim=2)
        idx = self.select(pc1, mask1, pc1, mask1)
        dirs = ops.group(pc1, idx) - pc1.unsqueeze(2)
        return torch.sum(self.weightnet2(dirs) * ops.group(cost, idx), dim=2)


class ClsPredictor(nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = MLP(256, (128, 64, 32))
        self.conv_out = nn.Linear(32, 3, bias=False)
        self.linear = nn.Linear(3, 1)

    def logit(self, x, mask):
        return self.linear(self.conv_out(self.mlp(x, mask)))[..., 0]

    def forward(self, x, mask):
        return torch.sigmoid(self.logit(x, mask))


class FlowPredictor(nn.Module):
    def __init__(self):
        super().__init__()
        self.mlp = MLP(256, (128, 64, 32))
        self.out = nn.Linear(32, 3, bias=False)

    def forward(self, x, mask):
        return self.out(self.mlp(x, mask))


class GRUCell(nn.Module):
    """torch's gate order r | z | n."""

    def __init__(self, c, hidden):
        super().__init__()
        self.ih = nn.Linear(c, 3 * hidden)
        self.hh = nn.Linear(hidden, 3 * hidden)

    def forward(self, x, h):
        i_r, i_z, i_n = self.ih(x).chunk(3, dim=-1)
        h_r, h_z, h_n = self.hh(h).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        return (1.0 - z) * torch.tanh(i_n + r * h_n) + z * h


class StackedGRU(nn.Module):
    def __init__(self, hidden, layers):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            self.add_module(f"cell_{i}", GRUCell(hidden, hidden))

    def forward(self, x, h):
        outs = []
        for i in range(self.layers):
            x = getattr(self, f"cell_{i}")(x, h[:, i])
            outs.append(x)
        return x, torch.stack(outs, dim=1)


def masked_max(x, mask):
    v = torch.where(mask.unsqueeze(-1), x,
                    torch.full_like(x, float("-inf"))).amax(dim=1)
    return torch.where(mask.any(dim=1, keepdim=True), v, torch.zeros_like(v))


class FlowDecoder(nn.Module):
    def __init__(self, npoint, feat_dim, gru_layers, exact_fps):
        super().__init__()
        self.cp = ClsPredictor()
        self.mse = PNHead(npoint, 2 + 256 + 256, exact_fps)
        self.gru = StackedGRU(feat_dim, gru_layers)
        self.fp = FlowPredictor()


class Affinity(nn.Module):
    """141 -> 564 -> 282 -> 70 -> 35 -> 1, ReLU, sigmoid."""

    def __init__(self, e=DESC_DIM):
        super().__init__()
        dims = [e, e * 4, e * 2, e // 2, e // 4]
        for i in range(4):
            self.add_module(f"dense_{i}", nn.Linear(dims[i], dims[i + 1]))
        self.dense_out = nn.Linear(dims[-1], 1)

    def forward(self, x):
        for i in range(4):
            x = torch.relu(getattr(self, f"dense_{i}")(x))
        return torch.sigmoid(self.dense_out(x))[..., 0]


class State(NamedTuple):
    """A stream's tracking state, batched: the GRU state, the previous
    frame's object descriptors, validity, track and GT ids, the id counter
    and the frame count."""
    h: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor
    track_id: torch.Tensor
    gt_id: torch.Tensor
    next_id: torch.Tensor
    frame_idx: torch.Tensor


def fresh_state(b, k, layers, hidden, device):
    i32 = dict(dtype=torch.int32, device=device)
    return State(torch.zeros((b, layers, hidden), device=device),
                 torch.zeros((b, k, DESC_DIM), device=device),
                 torch.zeros((b, k), dtype=torch.bool, device=device),
                 torch.full((b, k), -1, **i32), torch.full((b, k), -1, **i32),
                 torch.zeros((b,), **i32), torch.zeros((b,), **i32))


class Track4D(nn.Module):
    """The model of one configuration (the keys of its `model` block; the
    program's switches among them, such as `sinkhorn_kernel`, choose
    how the program computes and change nothing here)."""

    def __init__(self, npoint=512, k_max=32, feat_dim=128, gru_layers=5,
                 min_obj_points=2, dbscan_eps=1.5, dbscan_max_iters=64,
                 sinkhorn_iters=500, sinkhorn_alpha=0.9,
                 match_conf_thres=0.01, mov_thres=0.5, mov_budget=0,
                 exact_fps=False, **_):
        super().__init__()
        self.npoint, self.k_max = npoint, k_max
        self.feat_dim, self.gru_layers = feat_dim, gru_layers
        self.min_obj_points, self.dbscan_eps = min_obj_points, dbscan_eps
        self.dbscan_max_iters = dbscan_max_iters
        self.sinkhorn_iters, self.sinkhorn_alpha = sinkhorn_iters, sinkhorn_alpha
        self.match_conf_thres, self.mov_thres = match_conf_thres, mov_thres
        self.mov_budget = mov_budget
        self.pn_head = PNHead(npoint, 2, exact_fps)
        self.fc_layer = Correlator()
        self.fd_layer = FlowDecoder(npoint, feat_dim, gru_layers, exact_fps)
        self.affinity = Affinity()
        self.bin_score = nn.Parameter(torch.ones(()))

    def fresh_state(self, b, device):
        return fresh_state(b, self.k_max, self.gru_layers, self.feat_dim,
                           device)

    def features(self, fr):
        """A frame's pc1 features (with the cloud's max) and its cost
        volume (B, N, 256) each."""
        m1, m2 = fr.mask1, fr.mask2
        f1 = self.pn_head(fr.pc1, fr.ft1, m1)
        f2 = self.pn_head(fr.pc2, fr.ft2, m2)
        f1 = torch.cat([f1, masked_max(f1, m1).unsqueeze(1).expand_as(f1)],
                       dim=-1)
        f2 = torch.cat([f2, masked_max(f2, m2).unsqueeze(1).expand_as(f2)],
                       dim=-1)
        return f1, self.fc_layer(fr.pc1, fr.pc2, f1, f2, m1, m2)

    def cls_logit(self, fr):
        """The motion score's logit (B, N) of a frame."""
        return self.fd_layer.cp.logit(self.features(fr)[1], fr.mask1)

    def forward(self, fr, state: State):
        """One frame step over B streams: fr is a FrameBatch of (B, ...)
        tensors -> (outputs, new state)."""
        b, dev = fr.pc1.shape[0], fr.pc1.device
        fresh = self.fresh_state(b, dev)

        def pick(f, s):
            sel = fr.new_seq.reshape((b,) + (1,) * (s.dim() - 1))
            return torch.where(sel, f, s)
        # a new clip starts from a fresh state; track ids keep counting
        state = State(*[pick(f, s) for f, s in zip(fresh, state)]
                      )._replace(next_id=state.next_id)
        m1 = fr.mask1
        f1, cor = self.features(fr)
        dec = self.fd_layer
        cls = dec.cp(cor, m1)
        prop = dec.mse(fr.pc1, torch.cat([fr.ft1, f1, cor], dim=-1), m1)
        gout, h_new = dec.gru(masked_max(prop, m1), state.h)
        g = gout.unsqueeze(1).expand(-1, prop.shape[1], -1)
        flow = dec.fp(torch.cat([prop, g], dim=-1), m1)
        warp = fr.pc1 + flow
        feats = torch.cat([warp, fr.pc1, flow, fr.ft1, prop], dim=-1)
        # the clustering features: channels 3:9 and 10:12, as the
        # published model indexes them
        db_in = torch.cat([feats[..., 3:9], feats[..., 10:12]],
                          dim=-1).detach()
        mov = (cls > self.mov_thres) & m1
        if 0 < self.mov_budget < db_in.shape[1]:
            labels = compact_dbscan(db_in, mov, cls.detach(), self.mov_budget,
                                    self.dbscan_eps, self.min_obj_points,
                                    self.dbscan_max_iters)
        else:
            labels = dbscan(db_in, mov, self.dbscan_eps, self.min_obj_points,
                            self.dbscan_max_iters)
        labels = torch.where(labels < self.k_max, labels,
                             torch.full_like(labels, -1))
        desc, valid = cluster_descriptors(feats, labels, self.k_max)
        curr_gt = greedy_gt_match(labels, fr.gt_dense, fr.gt_label_ids,
                                  fr.gt_valid, self.k_max, state.frame_idx)
        n = valid.sum(dim=1).to(torch.int32)
        m = state.valid.sum(dim=1).to(torch.int32)
        aff = self.affinity(desc.unsqueeze(1) - state.desc.unsqueeze(2))
        track_id, conf, next_id = associate(
            aff.detach(), m, n, state.track_id, state.next_id,
            self.sinkhorn_alpha, self.sinkhorn_iters, self.match_conf_thres)
        new_state = State(h_new.detach(), desc.detach(), valid, track_id,
                          curr_gt, next_id, state.frame_idx + 1)
        out = dict(cls=cls, warp=warp, labels=labels, track_id=track_id,
                   conf=conf, n=n, aff=aff, prev_gt_id=state.gt_id,
                   prev_valid=state.valid, curr_gt_id=curr_gt,
                   curr_valid=valid)
        return out, new_state

"""Object descriptors, greedy GT matching and cross-frame association,
batched over streams. Counterpart of `ratrack_tpu/tracker/association.py`.

Channel layout of the 139-channel per-point tensor F (track4d.py:53-54):
  0:3 warped xyz | 3:6 original xyz | 6:9 flow | 9:11 [RCS, v_r]
  | 11:139 prop features (128).
Object descriptor (141-d):
  [mean(3:6), var(3:6), max(11:139), mean(6:9), mean(9:11), var(9:11)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..trace import span
from .sinkhorn import log_optimal_transport_masked
from .state import DESC_DIM

_NEG_INF = -1e30


@span("descriptors")
def cluster_descriptors(feats: torch.Tensor, labels: torch.Tensor,
                        k_max: int):
    """feats (B, N, 139), labels (B, N) in [-1, k_max) ->
    desc (B, K, 141), valid (B, K), sizes (B, K) int32, onehot (B, N, K)."""
    member = labels.unsqueeze(-1) == torch.arange(k_max, device=feats.device)
    oh = member.to(feats.dtype)
    oht = oh.transpose(1, 2)
    sizes = member.sum(dim=1).to(torch.int32)
    valid = sizes > 0
    denom = torch.clamp_min(sizes.to(feats.dtype), 1.0).unsqueeze(-1)

    def mean(sl):
        return (oht @ feats[..., sl]) / denom

    def var(sl):
        mu = mean(sl)
        sq = (oht @ torch.square(feats[..., sl])) / denom
        return torch.clamp_min(sq - torch.square(mu), 0.0)

    pos, pos_var = mean(slice(3, 6)), var(slice(3, 6))
    flow = mean(slice(6, 9))
    rrv, rrv_var = mean(slice(9, 11)), var(slice(9, 11))
    fmax = torch.where(member.unsqueeze(-1), feats[:, :, None, 11:139],
                       torch.tensor(_NEG_INF, device=feats.device)).amax(dim=1)
    fmax = torch.where(valid.unsqueeze(-1), fmax, torch.zeros_like(fmax))
    desc = torch.cat([pos, pos_var, fmax, flow, rrv, rrv_var], dim=-1)
    desc = torch.where(valid.unsqueeze(-1), desc, torch.zeros_like(desc))
    if desc.shape[-1] != DESC_DIM:
        raise ValueError(f"descriptor width {desc.shape[-1]} != {DESC_DIM}")
    return desc, valid, sizes, oh


@span("descriptors")
def greedy_gt_match(labels, gt_dense, gt_label_ids, gt_valid, k_max: int,
                    frame_idx) -> torch.Tensor:
    """Greedy point-IoU match of predicted clusters to GT objects, in slot
    order; unmatched slots get -(2 + frame_idx * k_max + slot).
    labels/gt_dense (B, N), gt_label_ids/gt_valid (B, G), frame_idx (B,)
    -> (B, K) int32."""
    dev = labels.device
    g_max = gt_label_ids.shape[-1]
    in_k = (labels.unsqueeze(-1)
            == torch.arange(k_max, device=dev)).to(torch.float32)
    in_g = (gt_dense.unsqueeze(-1)
            == torch.arange(g_max, device=dev)).to(torch.float32)
    common = in_k.transpose(1, 2) @ in_g                        # (B, K, G)
    size_k = in_k.sum(dim=1).unsqueeze(-1)
    size_g = in_g.sum(dim=1).unsqueeze(1)
    denom = torch.clamp_min(size_k + size_g - common, 1.0)
    iou = torch.where(gt_valid.unsqueeze(1), common / denom,
                      torch.zeros_like(common))

    g_ar = torch.arange(g_max, device=dev)
    used = torch.zeros(gt_valid.shape, dtype=torch.bool, device=dev)
    cols = []
    for k in range(k_max):
        row = torch.where(used, torch.zeros_like(iou[:, k]), iou[:, k])
        best = torch.argmax(row, dim=-1, keepdim=True)           # (B, 1)
        ok = torch.gather(row, 1, best)[:, 0] > 0.0
        unmatched = -(2 + frame_idx * k_max + k)
        cols.append(torch.where(ok, torch.gather(gt_label_ids, 1, best)[:, 0],
                                unmatched))
        used = used | ((g_ar == best) & ok.unsqueeze(1))
    return torch.stack(cols, dim=1).to(torch.int32)


class AssocResult(NamedTuple):
    track_id: torch.Tensor      # (B, K) int32 per curr slot (-1 invalid)
    conf: torch.Tensor          # (B, K) match confidence (aff's dtype)
    matched_prev: torch.Tensor  # (B, K) int32 prev slot or -1
    next_id: torch.Tensor       # (B,) int32 updated counter
    aff: torch.Tensor           # (B, K, K) raw affinity (prev x curr)


class MatchStructure(NamedTuple):
    """Who matches whom, at what confidence: the part of the association
    that depends on no track identity, so the pipelined eval step computes
    it for every frame of a block at once (JAX association.py:129-135)."""
    idx1: torch.Tensor      # (B, K) int64 best prev slot per curr slot
    matched: torch.Tensor   # (B, K) bool mutual-max match
    conf: torch.Tensor      # (B, K) affinity at the match (aff's dtype)
    col_ok: torch.Tensor    # (B, K) bool curr-slot validity


def match_structure(aff, m, n, alpha: float, iters: int,
                    sinkhorn_tol: float = 0.0, *,
                    use_fused_kernel: bool = False) -> MatchStructure:
    """Sinkhorn and mutual-max matching on aff (B, K, K) with m / n (B,)
    valid rows / columns. sinkhorn_tol > 0: the early exit.
    use_fused_kernel: the Sinkhorn iterations in kernel B7 (tol must be
    0)."""
    k = aff.shape[-1]
    dev = aff.device
    # safe_lse=False as the JAX association passes it (association.py:
    # 147-152): aff is a sigmoid in (0, 1) and alpha the 0.9 bin, where the
    # bounded log-sum-exp is exact enough and costs one reduction less.
    # Detached: z reaches nothing but the argmaxes, so no gradient flows
    # through it, and an input that requires grad would keep the Sinkhorn
    # off its CUDA graph. conf gathers from aff itself.
    z = log_optimal_transport_masked(aff.detach(), m, n, alpha, iters,
                                     tol=sinkhorn_tol, safe_lse=False,
                                     use_fused_kernel=use_fused_kernel)
    with span("assign_ids"):
        ar = torch.arange(k, device=dev)
        row_ok = ar.unsqueeze(0) < m.unsqueeze(1)
        col_ok = ar.unsqueeze(0) < n.unsqueeze(1)
        s = torch.where(row_ok.unsqueeze(2) & col_ok.unsqueeze(1),
                        z[:, :k, :k], torch.tensor(_NEG_INF, device=dev))
        idx0 = torch.argmax(s, dim=2)             # best curr per prev
        idx1 = torch.argmax(s, dim=1)             # best prev per curr
        mutual = torch.gather(idx0, 1, idx1) == ar
        matched = mutual & col_ok & torch.gather(row_ok, 1, idx1)
        conf = torch.gather(aff, 1, idx1.unsqueeze(1))[:, 0]
    return MatchStructure(idx1, matched, conf, col_ok)


@span("assign_ids")
def assign_ids(ms: MatchStructure, prev_track_id, next_id, aff,
               conf_thres: float = 0.01) -> AssocResult:
    """ID inheritance in slot order, the serial part: a new id where a
    slot is unmatched or conf < conf_thres, else the matched previous
    slot's id (JAX association.py:168-186)."""
    is_new = ms.col_ok & (~ms.matched | (ms.conf < conf_thres))
    inherit = ms.col_ok & ms.matched & (ms.conf >= conf_thres)
    new_rank = torch.cumsum(is_new.to(torch.int32), dim=1) - 1
    track_id = torch.where(
        inherit, torch.gather(prev_track_id, 1, ms.idx1),
        torch.where(is_new, next_id.unsqueeze(1) + new_rank,
                    torch.full_like(new_rank, -1))).to(torch.int32)
    conf_out = torch.where(inherit, ms.conf, torch.zeros_like(ms.conf))
    matched_prev = torch.where(inherit, ms.idx1,
                               torch.full_like(ms.idx1, -1)).to(torch.int32)
    new_next = (next_id + is_new.sum(dim=1)).to(torch.int32)
    return AssocResult(track_id, conf_out, matched_prev, new_next, aff)


def associate(aff, m, n, prev_track_id, next_id, alpha: float, iters: int,
              conf_thres: float = 0.01, use_fused_kernel: bool = False,
              sinkhorn_tol: float = 0.0) -> AssocResult:
    """Sinkhorn + mutual-max matching + ID inheritance in slot order:
    `assign_ids(match_structure(...))`. use_fused_kernel: the Sinkhorn
    iterations in kernel B7; sinkhorn_tol > 0: the early exit."""
    ms = match_structure(aff, m, n, alpha, iters, sinkhorn_tol,
                         use_fused_kernel=use_fused_kernel)
    return assign_ids(ms, prev_track_id, next_id, aff, conf_thres)

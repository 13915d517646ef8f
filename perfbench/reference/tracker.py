"""DBSCAN, object descriptors, GT matching and Sinkhorn association of the
reference, batched over streams.

Per-point tensor F (B, N, 139) = [warp 3 | pc1 3 | flow 3 | RCS, v_r 2 |
prop 128]; an object's descriptor (141) = [mean(3:6), var(3:6),
max(11:139), mean(6:9), mean(9:11), var(9:11)].
"""

from __future__ import annotations

import torch

from .ops import square_distance

_NEG_INF = -1e30
NEG = -1e9


def dbscan(x, mask, eps, min_samples, max_iters=64):
    """Min-label propagation over core points (>= min_samples neighbours
    within eps, itself included), border points adopt their least core
    neighbour's label, cluster ids rank the roots in index order; noise
    -1. x (B, N, D), mask (B, N) -> (B, N) int32. The propagation runs
    max_iters + 1 rounds, a fixpoint iteration."""
    n = x.shape[1]
    adj = ((square_distance(x, x) <= eps * eps)
           & mask.unsqueeze(1) & mask.unsqueeze(2))
    core = (adj.sum(dim=-1) >= min_samples) & mask
    core_adj = adj & core.unsqueeze(1) & core.unsqueeze(2)
    idx = torch.arange(n, device=x.device).expand_as(mask)
    sent = torch.full_like(idx, n)
    label = torch.where(core, idx, sent)
    for _ in range(max_iters + 1):
        nbr = torch.where(core_adj, label.unsqueeze(1),
                          torch.full_like(core_adj, n, dtype=label.dtype))
        label = torch.minimum(label, nbr.amin(dim=-1))
        jumped = torch.where(label < n,
                             torch.gather(label, 1, label.clamp(max=n - 1)),
                             sent)
        label = torch.minimum(label, jumped)
    border = torch.where(adj & core.unsqueeze(1), label.unsqueeze(1),
                         torch.full_like(adj, n, dtype=label.dtype))
    label = torch.where(core, label,
                        torch.where(mask, border.amin(dim=-1), sent))
    clustered = label < n
    rank = torch.cumsum((clustered & (label == idx)).to(torch.int64),
                        dim=-1) - 1
    return torch.where(clustered,
                       torch.gather(rank, 1, label.clamp(max=n - 1)),
                       torch.full_like(rank, -1)).to(torch.int32)


def compact_dbscan(x, mask, scores, budget, eps, min_samples, max_iters=64):
    """DBSCAN over the `budget` masked points of highest score (equal
    scores to the lower index), in index order; the rest -1."""
    keys = torch.where(mask, scores, torch.full_like(scores, float("-inf")))
    sel = torch.sort(keys, dim=-1, descending=True,
                     stable=True).indices[:, :budget]
    sel = torch.sort(sel, dim=-1).values
    sel_mask = torch.gather(mask, 1, sel)
    sub = dbscan(torch.gather(x, 1, sel.unsqueeze(-1).expand(
        -1, -1, x.shape[-1])), sel_mask, eps, min_samples, max_iters)
    labels = torch.full(mask.shape, -1, dtype=torch.int32, device=x.device)
    return labels.scatter_(1, sel, torch.where(sel_mask, sub,
                                               torch.full_like(sub, -1)))


def cluster_descriptors(feats, labels, k):
    """-> (desc (B, K, 141), valid (B, K))."""
    member = labels.unsqueeze(-1) == torch.arange(k, device=feats.device)
    oht = member.to(feats.dtype).transpose(1, 2)
    sizes = member.sum(dim=1)
    valid = sizes > 0
    denom = torch.clamp_min(sizes.to(feats.dtype), 1.0).unsqueeze(-1)

    def mean(sl):
        return (oht @ feats[..., sl]) / denom

    def var(sl):
        return torch.clamp_min((oht @ torch.square(feats[..., sl])) / denom
                               - torch.square(mean(sl)), 0.0)

    fmax = torch.where(member.unsqueeze(-1), feats[:, :, None, 11:139],
                       torch.tensor(_NEG_INF, device=feats.device)).amax(dim=1)
    desc = torch.cat([mean(slice(3, 6)), var(slice(3, 6)), fmax,
                      mean(slice(6, 9)), mean(slice(9, 11)),
                      var(slice(9, 11))], dim=-1)
    return torch.where(valid.unsqueeze(-1), desc, torch.zeros_like(desc)), \
        valid


def greedy_gt_match(labels, gt_dense, gt_ids, gt_valid, k, frame_idx):
    """Greedy point-IoU match of clusters to GT objects in slot order;
    unmatched slots get -(2 + frame_idx * k + slot) -> (B, K) int32."""
    dev = labels.device
    g = gt_ids.shape[-1]
    in_k = (labels.unsqueeze(-1) == torch.arange(k, device=dev)).float()
    in_g = (gt_dense.unsqueeze(-1) == torch.arange(g, device=dev)).float()
    common = in_k.transpose(1, 2) @ in_g
    denom = torch.clamp_min(in_k.sum(dim=1).unsqueeze(-1)
                            + in_g.sum(dim=1).unsqueeze(1) - common, 1.0)
    iou = torch.where(gt_valid.unsqueeze(1), common / denom,
                      torch.zeros_like(common))
    g_ar = torch.arange(g, device=dev)
    used = torch.zeros(gt_valid.shape, dtype=torch.bool, device=dev)
    cols = []
    for s in range(k):
        row = torch.where(used, torch.zeros_like(iou[:, s]), iou[:, s])
        best = torch.argmax(row, dim=-1, keepdim=True)
        ok = torch.gather(row, 1, best)[:, 0] > 0.0
        cols.append(torch.where(ok, torch.gather(gt_ids, 1, best)[:, 0],
                                -(2 + frame_idx * k + s)))
        used = used | ((g_ar == best) & ok.unsqueeze(1))
    return torch.stack(cols, dim=1).to(torch.int32)


def log_transport(scores, m, n, alpha, iters):
    """Log-space Sinkhorn with a dustbin on scores (B, K, K) with m / n
    valid rows / columns -> (B, K+1, K+1) log-coupling. Every finite
    operand lies in [-20, 20], so log-sum-exp needs no max pass."""
    b, k = scores.shape[0], scores.shape[-1]
    dev = scores.device
    ar = torch.arange(k, device=dev)
    row_ok = ar.unsqueeze(0) < m.unsqueeze(1)
    col_ok = ar.unsqueeze(0) < n.unsqueeze(1)
    mf = torch.clamp_min(m.float(), 1.0)
    nf = torch.clamp_min(n.float(), 1.0)
    norm = -torch.log(mf + nf)
    neg = torch.tensor(NEG, device=dev)
    a = torch.tensor(alpha, device=dev)
    c = torch.full((b, k + 1, k + 1), NEG, device=dev)
    c[:, :k, :k] = torch.where(row_ok.unsqueeze(2) & col_ok.unsqueeze(1),
                               scores, neg)
    c[:, :k, k] = torch.where(row_ok, a, neg)
    c[:, k, :k] = torch.where(col_ok, a, neg)
    c[:, k, k] = a
    log_mu = torch.cat([torch.where(row_ok, norm.unsqueeze(1), neg),
                        (torch.log(nf) + norm).unsqueeze(1)], dim=1)
    log_nu = torch.cat([torch.where(col_ok, norm.unsqueeze(1), neg),
                        (torch.log(mf) + norm).unsqueeze(1)], dim=1)

    def lse(x, dim):
        return torch.log(torch.clamp_min(torch.sum(torch.exp(x), dim=dim),
                                         1e-30))
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iters):
        u = log_mu - lse(c + v.unsqueeze(1), 2)
        v = log_nu - lse(c + u.unsqueeze(2), 1)
    return c + u.unsqueeze(2) + v.unsqueeze(1) - norm.reshape(-1, 1, 1)


def associate(aff, m, n, prev_id, next_id, alpha, iters, conf_thres):
    """Sinkhorn, mutual-max matching and id inheritance in slot order ->
    (track_id (B, K), conf (B, K), next_id (B,))."""
    k = aff.shape[-1]
    dev = aff.device
    z = log_transport(aff, m, n, alpha, iters)
    ar = torch.arange(k, device=dev)
    row_ok = ar.unsqueeze(0) < m.unsqueeze(1)
    col_ok = ar.unsqueeze(0) < n.unsqueeze(1)
    s = torch.where(row_ok.unsqueeze(2) & col_ok.unsqueeze(1), z[:, :k, :k],
                    torch.tensor(_NEG_INF, device=dev))
    idx0 = torch.argmax(s, dim=2)
    idx1 = torch.argmax(s, dim=1)
    matched = (torch.gather(idx0, 1, idx1) == ar) & col_ok \
        & torch.gather(row_ok, 1, idx1)
    conf = torch.gather(aff, 1, idx1.unsqueeze(1))[:, 0]
    is_new = col_ok & (~matched | (conf < conf_thres))
    inherit = col_ok & matched & (conf >= conf_thres)
    rank = torch.cumsum(is_new.to(torch.int32), dim=1) - 1
    track_id = torch.where(
        inherit, torch.gather(prev_id, 1, idx1),
        torch.where(is_new, next_id.unsqueeze(1) + rank,
                    torch.full_like(rank, -1))).to(torch.int32)
    conf = torch.where(inherit, conf, torch.zeros_like(conf))
    return track_id, conf, (next_id + is_new.sum(dim=1)).to(torch.int32)

"""On-device DBSCAN by min-label propagation, batched over streams.
Counterpart of `ratrack_tpu/tracker/dbscan.py` (`dbscan`, `compact_dbscan`).

  * adjacency: squared distance <= eps^2 among valid points;
  * core points: >= min_samples neighbours, the point itself included;
  * component label = min core index reachable over core-core edges,
    by min-label propagation with pointer jumping;
  * border points adopt their minimum-label core neighbour; noise -> -1;
  * cluster ids are ranks of the component roots in index order.

The JAX loop stops when no label changed, which in eager torch would be a
host sync every iteration. Here the propagation always runs max_iters
steps after the first: it is a fixpoint iteration, so the labels are
identical to the early-stopping loop (which is itself capped at
max_iters), and nothing syncs.
"""

from __future__ import annotations

import torch

from ..ops.neighborhood import square_distance


def dbscan(x: torch.Tensor, mask: torch.Tensor, eps: float,
           min_samples: int, max_iters: int = 64) -> torch.Tensor:
    """x (B, N, D), mask (B, N) -> (B, N) int32 labels, -1 for noise."""
    n = x.shape[1]
    sentinel = n
    adj = ((square_distance(x, x) <= eps * eps)
           & mask.unsqueeze(1) & mask.unsqueeze(2))
    core = (adj.sum(dim=-1) >= min_samples) & mask
    core_adj = adj & core.unsqueeze(1) & core.unsqueeze(2)
    idx = torch.arange(n, device=x.device).expand_as(mask)
    sent = torch.full_like(idx, sentinel)
    label = torch.where(core, idx, sent)

    def propagate(label):
        nbr = torch.where(core_adj, label.unsqueeze(1),
                          torch.full_like(core_adj, sentinel,
                                          dtype=label.dtype))
        label = torch.minimum(label, nbr.amin(dim=-1))
        jumped = torch.where(
            label < sentinel,
            torch.gather(label, 1, label.clamp(max=n - 1)), sent)
        return torch.minimum(label, jumped)

    label = propagate(label)
    for _ in range(max_iters):
        label = propagate(label)

    border = torch.where(adj & core.unsqueeze(1), label.unsqueeze(1),
                         torch.full_like(adj, sentinel, dtype=label.dtype))
    label = torch.where(core, label,
                        torch.where(mask, border.amin(dim=-1), sent))
    clustered = label < sentinel
    rank = torch.cumsum((clustered & (label == idx)).to(torch.int64),
                        dim=-1) - 1
    cluster = torch.where(clustered,
                          torch.gather(rank, 1, label.clamp(max=n - 1)),
                          torch.full_like(rank, -1))
    return cluster.to(torch.int32)


def compact_dbscan(x: torch.Tensor, mask: torch.Tensor, scores: torch.Tensor,
                   budget: int, eps: float, min_samples: int,
                   max_iters: int = 64) -> torch.Tensor:
    """DBSCAN over the `budget` masked points of highest score per stream
    (JAX `compact_dbscan`, :50-72): the O(N^2) adjacency shrinks to
    budget^2. x (B, N, D), mask / scores (B, N) -> (B, N) int32 labels.

    The selected indices are sorted ascending, so cluster numbering equals
    a full `dbscan` whenever at most `budget` points are masked in; beyond
    that the lowest scores are dropped (label -1). Unmasked points score
    -inf. Equal scores go to the lower index (`jax.lax.top_k`'s order,
    which `torch.topk` does not promise): a stable descending sort."""
    keys = torch.where(mask, scores, torch.full_like(scores, float("-inf")))
    sel = torch.sort(keys, dim=-1, descending=True,
                     stable=True).indices[:, :budget]
    sel = torch.sort(sel, dim=-1).values
    sel_mask = torch.gather(mask, 1, sel)
    sub = dbscan(torch.gather(x, 1, sel.unsqueeze(-1).expand(-1, -1,
                                                            x.shape[-1])),
                 sel_mask, eps, min_samples, max_iters)
    labels = torch.full(mask.shape, -1, dtype=torch.int32, device=x.device)
    return labels.scatter_(1, sel, torch.where(sel_mask, sub,
                                               torch.full_like(sub, -1)))

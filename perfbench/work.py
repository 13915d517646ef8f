"""The yardstick of the rooflines and of `mfu`, frozen with the benchmark.

Part 1 is a copy of the program's `kernels/cases.py` roofline section:
each `*_work` returns (bytes, product operations, other float32
operations) of one kernel call, every input byte read once and every
output byte written once, the operations these inputs need. Part 2 lists
the calls of one frame step of a cell, from its frames, with the
reference's own selections. Part 3 is the model's FLOPs a frame.

Peaks: the published H100 SXM rates, dense (NVIDIA's data sheet, at 700
W): HBM 3.35 TB/s, TF32 495 TFLOP/s (the fastest rate at which the card
takes float32 operands), float32 outside the tensor cores 67 TFLOP/s.
"""

from __future__ import annotations

import torch

from .reference import ops

HBM_BYTES_PER_S = 3.35e12
PRODUCT_OPS_PER_S = 495e12
FP32_OPS_PER_S = 67e12

# ---- part 1: kernels/cases.py's work counts --------------------------------

DIST_OPS = 10   # one expanded-form distance and its comparison
CORR_C = 256


def case_bytes(*trees) -> int:
    """Bytes of every tensor in the given cases / outputs (dicts, lists,
    tuples, tensors; anything else counts 0): each read or written once."""
    total = 0
    for tree in trees:
        if torch.is_tensor(tree):
            total += tree.numel() * tree.element_size()
        elif isinstance(tree, dict):
            total += case_bytes(*tree.values())
        elif isinstance(tree, (list, tuple)):
            total += case_bytes(*tree)
    return total


def _filled(idx):
    """Filled slots per center of a ball query's (B, M, ns) indices
    (padding slots repeat slot 0)."""
    return (idx != idx[..., :1]).sum(-1) + 1


def _slot_ops(c1: int, rest):
    """(Product, other) operations of the folded MLP on one filled slot."""
    return (sum(2 * w.shape[0] * w.shape[1] for w, _ in rest),
            2 * c1 + sum(2 * w.shape[1] for w, _ in rest))


def sa_pair_work(kw: dict, out_a, out_b, idx_a, idx_b):
    """B1 -> (bytes, product ops, other ops). Operations: the scan of each
    center up to where both slot lists are full (the whole cloud
    otherwise), and the folded MLP over the filled slots only."""
    n = kw["xyz"].shape[1]
    mm, ops_, full, last = 0, 0, [], []
    for tag, idx, ns in (("a", idx_a, kw["nsample_a"]),
                         ("b", idx_b, kw["nsample_b"])):
        filled = int(_filled(idx).sum())
        slot_mm, slot_ops = _slot_ops(kw[f"p1{tag}"].shape[-1],
                                      kw[f"rest_{tag}"])
        mm += filled * slot_mm
        ops_ += filled * slot_ops
        full.append(_filled(idx) >= ns)
        last.append(idx.amax(-1) + 1)
    scanned = torch.where(full[0] & full[1], torch.maximum(*last),
                          torch.full_like(last[0], n))
    ops_ += DIST_OPS * int(scanned.sum())
    return case_bytes(kw, out_a, out_b), mm, ops_


def _pair_ops(kw: dict):
    """(Product, other) operations per (query, slot) pair of a correlator
    stage."""
    c = CORR_C
    mm = 2 * (3 * 8 + 8 * 8 + 8 * c)                  # WeightNet
    ops_ = 2 * c                                      # the slot sum
    mm += sum(2 * w.shape[0] * w.shape[1] for w in kw["mlp_ws"])
    ops_ += sum(2 * w.shape[1] for w in kw["mlp_ws"])
    if kw["add_q"] is not None:
        ops_ += 2 * c
    if kw.get("w_dir") is not None:
        mm += 2 * 3 * c
    return mm, ops_


def corr_work(kw: dict, out, select: bool = True):
    """B3 (select=True: with the kNN's one pass of distances), B4 or B10's
    forward -> (bytes, product ops, other ops)."""
    b, n, _ = kw["query"].shape
    m = kw["points"].shape[1]
    mm, ops_ = _pair_ops(kw)
    ops_ *= b * n * 16
    if select:
        ops_ += DIST_OPS * b * n * m
    return case_bytes(kw, out), b * n * 16 * mm, ops_


def corr_train_bwd_work(kw: dict, out):
    """B10's backward -> (bytes, product ops, other ops): per pair layer a
    dW and a dh product; it reads the forward's inputs, the cotangent and
    the stashed activations ((n_mlp + 1) x (B N 16, 256) for stage 1) and
    writes a gradient per input."""
    b, n, _ = kw["query"].shape
    rows = b * n * 16
    n_mlp = len(kw["mlp_ws"])
    stash = (n_mlp + 1) * rows * CORR_C * 4 if kw["add_q"] is not None else 0
    mm, ops_ = _pair_ops(kw)
    return (2 * case_bytes(kw) + case_bytes(out) + stash, 2 * rows * mm,
            2 * rows * ops_)


def _train_slot_ops(widths):
    """(Product, other) operations of the train-mode MLP on one slot: layer
    1's coordinate term and the Dense layers; batch norm, ReLU and max per
    channel."""
    return (2 * 3 * widths[0]
            + sum(2 * i * o for i, o in zip(widths[:-1], widths[1:])),
            sum(6 * w for w in widths))


def sa_train_work(kw: dict, outs: dict):
    """B9 -> (forward (bytes, product ops, other ops), backward (...)).
    Train-mode batch norm counts every slot, padding included, so the MLP
    runs over all M x nsample slots; the backward is a dW and a dh product
    per layer."""
    b, n, _ = kw["xyz"].shape
    m = kw["centers"].shape[1]
    mm = ops_ = 0
    for tag in "ab":
        widths = [kw[f"wxyz_{tag}"].shape[1]] + [w.shape[1]
                                                 for w in kw[f"ws_{tag}"]]
        slot_mm, slot_ops = _train_slot_ops(widths)
        mm += b * m * kw[f"nsample_{tag}"] * slot_mm
        ops_ += b * m * kw[f"nsample_{tag}"] * slot_ops
    fwd_bytes = case_bytes(kw, outs)
    return ((fwd_bytes, mm, ops_ + DIST_OPS * b * m * n),
            (2 * fwd_bytes, 2 * mm, 2 * ops_))


def knn_tiled_work(kw: dict, idx, keys):
    """B5 -> (bytes, 0, operations): one distance and comparison per query
    and valid candidate."""
    b, n, _ = kw["query"].shape
    valid = (int(kw["points_mask"].sum()) if kw["points_mask"] is not None
             else b * kw["points"].shape[1])
    return case_bytes(kw, idx, keys), 0, DIST_OPS * n * valid


def bound_s(work) -> float:
    """The least seconds the card could take for (bytes, products, other
    operations)."""
    nbytes, mm, other = work
    return max(nbytes / HBM_BYTES_PER_S, mm / PRODUCT_OPS_PER_S,
               other / FP32_OPS_PER_S)


# ---- part 2: the calls of a frame step --------------------------------------

SA_LEVELS = (  # radii, nsamples, per-scale widths
    ((2.0, 4.0), (4, 8), ((16, 16, 32), (16, 16, 32))),
    ((4.0, 8.0), (8, 16), ((32, 32), (32, 64))),
    ((8.0, 16.0), (16, 32), ((64, 64), (64, 64))),
)


def _t(*shape, dtype=torch.float32):
    """A tensor that stands for its shape and dtype alone."""
    return torch.empty(shape, dtype=dtype, device="meta")


def level_clouds(pc, mask, npoint, exact_fps):
    """[(xyz, centers, mask)] of the three levels of a head over one
    cloud, with the reference's selections."""
    out, xyz, m = [], pc, mask
    for _ in SA_LEVELS:
        n = xyz.shape[1]
        if npoint == n and not exact_fps:
            centers = xyz if m is None else ops.gather(
                xyz, ops.identity_sample(n, n, m))
        else:
            centers = ops.gather(xyz, ops.farthest_point_sample(
                xyz, npoint, m))
        out.append((xyz, centers, m))
        xyz, m = centers, None
    return out


def sa_eval_calls(clouds):
    """B1's work for the three levels of a head over `level_clouds`."""
    works = []
    for (radii, nss, mlps), (xyz, centers, m) in zip(SA_LEVELS, clouds):
        b, n, m_ = xyz.shape[0], xyz.shape[1], centers.shape[1]
        kw = dict(xyz=_t(b, n, 3), centers=_t(b, m_, 3),
                  mask=None if m is None else _t(b, n, dtype=torch.bool),
                  nsample_a=nss[0], nsample_b=nss[1])
        outs, idxs = [], []
        for tag, widths, r, ns in zip("ab", mlps, radii, nss):
            kw[f"p1{tag}"] = _t(b, n, widths[0])
            kw[f"cw{tag}"] = _t(b, m_, widths[0])
            kw[f"rest_{tag}"] = [(_t(i, o), _t(o)) for i, o in
                                 zip(widths[:-1], widths[1:])]
            outs.append(_t(b, m_, widths[-1]))
            idxs.append(ops.ball_query(r, ns, xyz, centers, m))
        works.append(sa_pair_work(kw, *outs, *idxs))
    return works


def sa_train_calls(clouds):
    """B9's forward and backward work for the three levels of a head."""
    works = []
    for (_, nss, mlps), (xyz, centers, m) in zip(SA_LEVELS, clouds):
        b, n, m_ = xyz.shape[0], xyz.shape[1], centers.shape[1]
        kw = dict(xyz=_t(b, n, 3), centers=_t(b, m_, 3),
                  mask=None if m is None else _t(b, n, dtype=torch.bool),
                  nsample_a=nss[0], nsample_b=nss[1])
        outs = {}
        for tag, widths, ns in zip("ab", mlps, nss):
            kw[f"pf{tag}"] = _t(b, n, widths[0])
            kw[f"wxyz_{tag}"] = _t(3, widths[0])
            kw[f"ws_{tag}"] = [_t(i, o) for i, o in zip(widths[:-1],
                                                        widths[1:])]
            kw[f"gammas_{tag}"] = [_t(c) for c in widths]
            kw[f"betas_{tag}"] = [_t(c) for c in widths]
            outs[f"pooled_{tag}"] = _t(b, m_, widths[-1])
            outs[f"idx_{tag}"] = _t(b, m_, ns, dtype=torch.int32)
            for li, c in enumerate(widths):
                outs[f"mu_{tag}{li}"] = _t(b, c)
                outs[f"var_{tag}{li}"] = _t(b, c)
        works.extend(sa_train_work(kw, outs))
    return works


def _corr_kw(stage, b, n, m, train):
    c = CORR_C
    kw = dict(query=_t(b, n, 3), points=_t(b, m, 3), feats_p=_t(b, m, c),
              add_q=_t(b, n, c) if stage == 1 else None,
              mlp_ws=[_t(c, c)] * 2 if stage == 1 else [],
              mlp_bs=[_t(c)] * 2 if stage == 1 else [],
              wn_ws=[_t(3, 8), _t(8, 8), _t(8, c)],
              wn_bs=[_t(8), _t(8), _t(c)])
    if train:
        kw["w_dir"] = _t(3, c) if stage == 1 else None
    return kw


def corr_eval_calls(pc1, mask1, mask2):
    """B3's work (both stages, selection included) of one frame step over
    (B, N) clouds."""
    b, n = mask1.shape
    works = []
    for stage in (1, 2):
        kw = _corr_kw(stage, b, n, n, train=False)
        kw["mask_p"] = _t(b, n, dtype=torch.bool)
        works.append(corr_work(kw, _t(b, n, CORR_C)))
    return works


def corr_split_calls(pc1, mask1, mask2):
    """B5's and B4's work (both stages) of one frame step of the split
    correlator."""
    b, n = mask1.shape
    works = []
    for stage, pmask in ((1, mask2), (2, mask1)):
        sel = dict(query=_t(b, n, 3), points=_t(b, n, 3),
                   points_mask=pmask, k=16)
        idx = _t(b, n, 16, dtype=torch.int64)
        works.append(knn_tiled_work(sel, idx, _t(b, n, 16)))
        kw = _corr_kw(stage, b, n, n, train=False)
        kw["idx"] = idx
        works.append(corr_work(kw, _t(b, n, CORR_C), select=False))
    return works


def corr_train_calls(pc1, mask1, mask2):
    """B10's forward and backward work (both stages) of one frame step."""
    b, n = mask1.shape
    works = []
    for stage in (1, 2):
        kw = _corr_kw(stage, b, n, n, train=True)
        kw["mask_p"] = _t(b, n, dtype=torch.bool)
        out = _t(b, n, CORR_C)
        works += [corr_work(kw, out), corr_train_bwd_work(kw, out)]
    return works


# ---- part 3: model FLOPs ----------------------------------------------------

def _macs(dims):
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def pnhead_macs(n: int, npoint: int, c_feat: int) -> int:
    macs = 0
    for li, (_, nss, mlps) in enumerate(SA_LEVELS):
        c_in = 3 + (c_feat if li == 0 else (32, 64)[li - 1])
        for ns, widths in zip(nss, mlps):
            macs += npoint * ns * _macs((c_in,) + widths)
    macs += npoint * (64 * 32 + 96 * 64 + 128 * 64)        # linear1-3
    macs += npoint * (128 * 128 + 160 * 128) + n * 128 * 128  # fp3, fp2, fp1
    return macs


def model_flops_per_frame(model: dict, n_max: int, train: bool) -> int:
    """2 x the multiply-adds of every linear layer of one stream's frame
    step over the padded shapes the model is defined on (n_max points,
    npoint centers, nsample slots, 16 correlator neighbours, k_max objects
    a frame); training counts 3 x the forward."""
    n, npoint, k = n_max, model["npoint"], model["k_max"]
    c, h = 256, model["feat_dim"]
    macs = 2 * pnhead_macs(n, npoint, 2)                   # both clouds
    macs += n * 16 * _macs((2 * c + 3, c, c, c))           # correlator
    macs += 2 * n * 16 * _macs((3, 8, 8, c))               # WeightNets
    macs += n * (_macs((c, 128, 64, 32, 3, 1)))            # cls
    macs += pnhead_macs(n, npoint, 2 + 2 * c)              # embedding head
    macs += model["gru_layers"] * 2 * h * 3 * h            # GRU
    macs += n * _macs((c, 128, 64, 32, 3))                 # flow
    macs += k * k * _macs((141, 564, 282, 70, 35, 1))      # affinity
    return 2 * macs * (3 if train else 1)

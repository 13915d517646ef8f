"""CLEAR-MOT + AMOTA/sAMOTA metrics over point-set tracks.

The port's own copy of `ratrack_tpu/eval/mot_metrics.py`, held equal to
it by tests/test_torch_port_eval.py.

Re-implementation of the evaluation capability behind the reference's
published table (`README.md:167-170`): the authors score RaTrack's
per-frame point-set tracks with a modified AB3DMOT evaluation (not
distributed — README.md:174-176). The vendored pieces that define the
semantics are:
  * point-set IoU as the affinity (src/AB3DMOT_libs/dist_metrics.py:167-186
    — |A∩B| / |A∪B| with points matched by near-identical position);
  * CLEAR-MOT counting with greedy matching per frame;
  * AMOTA/AMOTP/sAMOTA: MOTA/MOTP integrated over recall by sweeping the
    detection confidence threshold (AB3DMOT evaluation protocol).

Inputs are frame-aligned lists of GT objects (id → (M,3) points) and
predictions ((conf, track_id, (M,3) points)) — exactly what
`eval/export.py` reads back from the results tree.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

Pred = Tuple[float, int, np.ndarray]          # (conf, track_id, points)
GTFrame = Dict[int, np.ndarray]               # gt id → points
PredFrame = List[Pred]


def namespace_ids(gt_frames: Sequence[GTFrame],
                  pred_frames: Sequence[PredFrame], clip_idx: int):
    """Offset GT and track ids into a per-clip namespace.

    Required before concatenating clips into one CLEAR-MOT pass: GT ids
    and tracker ids are only unique within a sequence (synthetic clips all
    use ids 100+, KITTI-style tracking ids restart per sequence, and each
    batched-eval stream allocates track ids from its own counter). Without
    namespacing, id reuse across clip boundaries manufactures ID switches
    and merges trajectories of physically distinct objects in MT/ML.
    """
    off = (clip_idx + 1) * 10 ** 7
    g2 = [{gid + off: pts for gid, pts in f.items()} for f in gt_frames]
    p2 = [[(c, tid + off if tid >= 0 else tid - off, pts)
           for c, tid, pts in f] for f in pred_frames]
    return g2, p2


def point_set_iou(a: np.ndarray, b: np.ndarray, tol: float = 1e-4) -> float:
    """|A∩B| / |A∪B| with membership by (near-)exact position match."""
    if a.size == 0 or b.size == 0:
        return 0.0
    d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
    common = int((d.min(axis=1) < tol).sum())
    union = a.shape[0] + b.shape[0] - common
    return common / union if union else 0.0


class _FrameCache(NamedTuple):
    """Per-frame match candidates, computed once per evaluation.

    The O(|gt|·|pred|·M·N) point-set IoUs dominate MOT scoring; caching
    them lets the recall sweep re-run only the cheap greedy matching."""
    pairs: List[Tuple[float, int, int]]   # (iou, gt_id, pred_idx) desc
    confs: List[float]                    # per original pred index
    tids: List[int]
    gt_ids: List[int]


def _build_cache(gt_frames: Sequence[GTFrame],
                 pred_frames: Sequence[PredFrame],
                 iou_thres: float) -> List[_FrameCache]:
    caches = []
    for gts, preds in zip(gt_frames, pred_frames):
        pairs = []
        for g, gpts in gts.items():
            for i, (_, _, ppts) in enumerate(preds):
                iou = point_set_iou(gpts, ppts)
                if iou >= iou_thres:
                    pairs.append((iou, g, i))
        pairs.sort(reverse=True)
        caches.append(_FrameCache(pairs, [p[0] for p in preds],
                                  [p[1] for p in preds], list(gts)))
    return caches


def _match_frame(cache: _FrameCache, keep, method: str):
    """Per-frame GT↔pred matching among above-threshold pairs.

    "greedy": descending-IoU greedy (the default interpretation);
    "hungarian": maximum-total-IoU assignment — what AB3DMOT's own
    data_association uses (src/AB3DMOT_libs/matching.py:51-113, the vod
    preset `model.py:82-84` selects 'hungarian'). Both operate on the
    same candidate pairs (IoU >= iou_thres); see PARITY.md "MOT protocol
    interpretation" for the deviation discussion.
    """
    pairs = [(iou, g, i) for iou, g, i in cache.pairs if keep[i]]
    if method == "greedy":
        used_g, used_p = set(), set()
        matches = []
        for iou, g, i in pairs:
            if g in used_g or i in used_p:
                continue
            used_g.add(g)
            used_p.add(i)
            matches.append((g, i, iou))
        return matches
    if method != "hungarian":
        raise ValueError(method)
    if not pairs:
        return []
    from scipy.optimize import linear_sum_assignment
    gs = sorted({g for _, g, _ in pairs})
    ps = sorted({i for _, _, i in pairs})
    gi = {g: a for a, g in enumerate(gs)}
    pi = {p: a for a, p in enumerate(ps)}
    cost = np.zeros((len(gs), len(ps)))
    for iou, g, i in pairs:
        cost[gi[g], pi[i]] = max(cost[gi[g], pi[i]], iou)
    rows, cols = linear_sum_assignment(-cost)
    return [(gs[r], ps[c], cost[r, c])
            for r, c in zip(rows, cols) if cost[r, c] > 0.0]


def _clear_mot_cached(caches: Sequence[_FrameCache],
                      conf_thres: float = -np.inf,
                      match: str = "greedy") -> Dict[str, float]:
    tp = fp = fn = idsw = 0
    iou_sum = 0.0
    last_match: Dict[int, int] = {}            # gt id → last matched track
    gt_hits: Dict[int, int] = defaultdict(int)
    gt_total: Dict[int, int] = defaultdict(int)
    n_gt = 0
    for c in caches:
        keep = [conf >= conf_thres for conf in c.confs]
        n_kept = sum(keep)
        n_gt += len(c.gt_ids)
        for g in c.gt_ids:
            gt_total[g] += 1
        matches = _match_frame(c, keep, match)
        tp += len(matches)
        fp += n_kept - len(matches)
        fn += len(c.gt_ids) - len(matches)
        for g, i, iou in matches:
            iou_sum += iou
            gt_hits[g] += 1
            tid = c.tids[i]
            if g in last_match and last_match[g] != tid:
                idsw += 1
            last_match[g] = tid

    mota = 1.0 - (fp + fn + idsw) / max(n_gt, 1)
    moda = 1.0 - (fp + fn) / max(n_gt, 1)
    motp = iou_sum / max(tp, 1)
    ratios = [gt_hits[g] / gt_total[g] for g in gt_total]
    mt = float(np.mean([r >= 0.8 for r in ratios])) if ratios else 0.0
    ml = float(np.mean([r < 0.2 for r in ratios])) if ratios else 0.0
    recall = tp / max(tp + fn, 1)
    precision = tp / max(tp + fp, 1)
    return {"mota": mota, "moda": moda, "motp": motp, "mt": mt, "ml": ml,
            "idsw": idsw, "tp": tp, "fp": fp, "fn": fn, "recall": recall,
            "precision": precision, "n_gt": n_gt}


def clear_mot(gt_frames: Sequence[GTFrame], pred_frames: Sequence[PredFrame],
              iou_thres: float = 0.25,
              conf_thres: float = -np.inf,
              match: str = "greedy") -> Dict[str, float]:
    """CLEAR-MOT over a sequence (predictions below conf_thres dropped)."""
    assert len(gt_frames) == len(pred_frames)
    return _clear_mot_cached(_build_cache(gt_frames, pred_frames,
                                          iou_thres), conf_thres, match)


def integrated_mot(gt_frames: Sequence[GTFrame],
                   pred_frames: Sequence[PredFrame],
                   iou_thres: float = 0.25,
                   n_recall: int = 40,
                   max_thresholds: int = 256,
                   match: str = "greedy") -> Dict[str, float]:
    """AMOTA / AMOTP / sAMOTA by sweeping recall (AB3DMOT protocol).

    For each target recall r in {1/n, …, 1}, pick the confidence threshold
    whose operating point reaches at least r, evaluate MOTA/MOTP there, and
    average. sAMOTA uses the scale-adjusted
    sMOTA_r = max(0, 1 − (FP+FN+IDSW − (1−r)·n_gt) / (r·n_gt)).

    Point-set IoUs are computed once; the sweep re-runs only greedy
    matching. Raw sigmoid confidences are nearly all distinct, so the
    operating points are capped at `max_thresholds` rank-uniform samples
    of the sorted confidence list (covering the full recall range).
    """
    caches = _build_cache(gt_frames, pred_frames, iou_thres)
    confs = sorted({p[0] for frame in pred_frames for p in frame},
                   reverse=True)
    if not confs:
        return {"samota": 0.0, "amota": 0.0, "amotp": 0.0,
                **_clear_mot_cached(caches, match=match)}
    if len(confs) > max_thresholds:
        pick = np.unique(np.linspace(0, len(confs) - 1,
                                     max_thresholds).astype(int))
        confs = [confs[i] for i in pick]

    ops = []
    for c in confs:
        ops.append((c, _clear_mot_cached(caches, c, match)))

    amota = amotp = samota = 0.0
    targets = [(i + 1) / n_recall for i in range(n_recall)]
    for r in targets:
        best = None
        for c, m in ops:
            if m["recall"] >= r:
                best = m
                break
        if best is None:
            continue
        amota += max(0.0, best["mota"])
        amotp += best["motp"]
        n_gt = max(best["n_gt"], 1)
        smota = 1.0 - (best["fp"] + best["fn"] + best["idsw"]
                       - (1.0 - r) * n_gt) / max(r * n_gt, 1e-9)
        samota += float(np.clip(smota, 0.0, 1.0))
    base = _clear_mot_cached(caches, match=match)
    return {"samota": samota / n_recall, "amota": amota / n_recall,
            "amotp": amotp / n_recall, **base}

"""Each cell's run end to end on the CPU at a tiny size (tests/tiny.py),
the look for a card skipped: the program against the reference comes out
correct, and the control and every fault the cell can have come out not
correct, each failing at least one of the cell's numbers by its own
limit."""

import time

import pytest
import torch

from perfbench import check, harness, spec, traffic
from perfbench.tests.tiny import CPU, SEED, run, tiny_cell
from perfbench.weights import (CLS_BIAS, make_state_dict,
                               place_motion_threshold)

# one process on one device; the four-card cell: test_perfbench_ranks.py
CELLS = [w["name"] for w in spec.benchmark()["workloads"] if w["chips"] == 1]
KIND = {c: spec.entry_module(spec.cell(c).workload["entry"]).Entry.kind
        for c in CELLS}


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    assert res["attempted"] > 0
    e2e = {m["name"] for m in spec.cell(name).end_to_end}
    assert set(res["metrics"]) == e2e


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_is_correct(name):
    res = run(name, trace=True)
    assert res["correct"], res["check"]
    assert res["device"]["window_s"] > 0
    # the CPU has no device trace, so only the window's share reads
    assert {m for m in res["metrics"] if not m.startswith("mfu")} <= {
        f"launches_per_frame.{KIND[name]}", f"device_idle_pct.{KIND[name]}"}


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference in TF32 in the program's place, on the frames that
    a run compares."""
    cell = tiny_cell(name)
    m = harness.run_program(cell, SEED, 1.0, False, CPU,
                            time.perf_counter())
    weights, frames = m.weights, m.frames
    limits = cell.workload["check"]["limits"]
    if KIND[name] == "eval":
        ref = check.reference_eval(cell, weights, frames)
        ctl = check.reference_eval(cell, weights, frames, control=True)
        values = check.eval_numbers(ctl, ref, frames.mask1)
    else:
        ref = check.reference_train(cell, weights, frames)
        ctl = check.reference_train(cell, weights, frames, control=True)
        values = check.train_numbers(ctl, ref, weights)
    assert not check.verdict(values, limits)[0], values


def _eval_faults(monkeypatch, fault):
    from ratrack_tpu_torch.models.track4d import Track4D
    from ratrack_tpu_torch.train import step
    if fault == "state_unchanged":
        orig = Track4D.step_cached

        def stale(self, frame, state, f2):
            out, _, f1 = orig(self, frame, state, f2)
            return out, state, f1
        monkeypatch.setattr(Track4D, "step_cached", stale)
        return
    orig_make = step.make_scan_eval_step_cached

    def make(model, mesh=None):
        scan = orig_make(model, mesh)

        def broken(state, frames):
            state, out = scan(state, frames)
            out = {k: v.clone() for k, v in out.items()}
            if fault == "half_batch":      # the second half left out
                h = out["cls"].shape[0] // 2
                for v in out.values():
                    v[h:] = v[:h]
            else:                          # one answer altered
                out["cls"][0, 0, 0] += 0.05
            return state, out
        return broken
    monkeypatch.setattr(step, "make_scan_eval_step_cached", make)


def _train_faults(monkeypatch, fault):
    from ratrack_tpu_torch.train import step
    if fault == "state_unchanged":     # the step leaves every parameter
        monkeypatch.setattr(step, "optimizer_step",
                            lambda ts: setattr(ts, "step", ts.step + 1))
        return
    orig = step.track4d_loss

    def broken(out, frame, pretrain):
        total, items = orig(out, frame, pretrain)
        if fault == "half_batch":      # the mean over the first half
            return total[:total.shape[0] // 2], items
        items = dict(items, Loss=items["Loss"] * 1.01)   # an answer altered
        return total, items
    monkeypatch.setattr(step, "track4d_loss", broken)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    (_eval_faults if KIND[name] == "eval" else _train_faults)(monkeypatch,
                                                             fault)
    res = run(name)
    assert not res["correct"], res["check"]


EVAL_CELLS = [c for c in CELLS if KIND[c] == "eval"]


@pytest.mark.parametrize("name", EVAL_CELLS)
def test_motion_threshold_moves_the_share_asked(name):
    """The shifted bias puts the share asked of the probe frame's points
    above the threshold, in the reference and in the program."""
    from ratrack_tpu_torch.models.track4d import Track4D
    cell = tiny_cell(name)
    args, share = cell.config["model"], cell.workload["moving_share"]
    pool = traffic.make_pool(cell.traffic, SEED, CPU)
    frame = traffic.frame_at(pool, 0)
    weights = place_motion_threshold(
        args, make_state_dict(args, SEED, CPU), frame, share)
    ref = check.reference_model(cell, weights, CPU).eval()
    with torch.no_grad():
        cls = torch.sigmoid(ref.cls_logit(frame))[frame.mask1]
    moving = float((cls > args["mov_thres"]).float().mean())
    assert abs(moving - share) <= 2.0 / cls.numel(), moving
    prog = Track4D(**args, device=CPU)
    prog.load_state_dict(weights)
    assert torch.equal(prog.state_dict()[CLS_BIAS], weights[CLS_BIAS])


@pytest.mark.parametrize("name", EVAL_CELLS)
def test_run_with_no_moving_point_is_not_correct(name, monkeypatch):
    """Where no point scores above the threshold, the reference clusters
    nothing and the run compares no cluster: not correct."""
    def far_below(*args):
        w = place_motion_threshold(*args)
        return dict(w, **{CLS_BIAS: w[CLS_BIAS] - 100.0})
    monkeypatch.setattr(harness, "place_motion_threshold", far_below)
    res = run(name)
    assert res["check"]["unclustered"]["value"] == 1.0
    assert not res["correct"], res["check"]


def test_associations():
    """Which slot of the frame before each slot continues: ids 7 and 9
    carry on from slots 0 and 1, id 12 is new, slot 2 of frame 0 is
    empty; the same structure under other ids reads the same."""
    ids = torch.tensor([[[7, 9, -1], [9, 12, 7]]])
    want = [[[-1, -1, -2], [1, -1, 0]]]
    assert check.associations(ids).tolist() == want
    assert check.associations(ids + 100 * (ids >= 0)).tolist() == want

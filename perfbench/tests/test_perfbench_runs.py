"""Each one-card cell's run end to end on the CPU at a tiny size
(tests/tiny.py), the look for a card skipped: the program against the
reference comes out correct, and the control and every fault that the
cell's family lists (FAULTS) come out not correct, each failing at least
one of the cell's numbers by its own limit. The cells are
BENCHMARK.json's and the test-only family `flow`'s."""

import time

import pytest
import torch

from perfbench import check, harness, traffic
from perfbench import weights as seeded
from perfbench.tests.tiny import (CPU, SEED, kind, one_card_cells, run,
                                  tiny_cell)
from perfbench.weights import CLS_BIAS, place_motion_threshold

CELLS = one_card_cells()
KIND = {c: kind(tiny_cell(c)) for c in CELLS}
FAULTS = [(c, f) for c in CELLS for f in tiny_cell(c).family.FAULTS]


@pytest.mark.parametrize("name", CELLS)
def test_run_is_correct(name):
    res = run(name)
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    assert res["attempted"] > 0
    e2e = {m["name"] for m in tiny_cell(name).end_to_end}
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
    """The control (the reference in TF32) in the program's place, on
    the frames that a run compares."""
    cell = tiny_cell(name)
    m = harness.run_program(cell, SEED, 1.0, False, CPU,
                            time.perf_counter())
    ctl = cell.family.reference(KIND[name], cell, m.weights, m.frames,
                                control=True)
    values = harness.numbers(cell, KIND[name], m.weights, m.frames, ctl)
    limits = cell.workload["check"]["limits"]
    assert not check.verdict(values, limits)[0], values


@pytest.mark.parametrize("name,fault", FAULTS)
def test_fault_is_not_correct(name, fault, monkeypatch):
    tiny_cell(name).family.FAULTS[fault](monkeypatch, KIND[name])
    res = run(name)
    assert not res["correct"], res["check"]


# the cells whose set-up shifts RaTrack's motion bias (family.prepare)
MOVING_CELLS = [c for c in CELLS if "moving_share" in tiny_cell(c).workload]


@pytest.mark.parametrize("name", MOVING_CELLS)
def test_motion_threshold_moves_the_share_asked(name):
    """The shifted bias puts the share asked of the probe frame's points
    above the threshold, in the reference and in the program (the
    family's preparation of the seeded weights)."""
    from ratrack_tpu_torch.models.track4d import Track4D
    cell = tiny_cell(name)
    args, share = cell.config["model"], cell.workload["moving_share"]
    pool = traffic.make_pool(cell.traffic, SEED, CPU)
    frame = traffic.frame_at(pool, 0)
    weights = cell.family.prepare(
        cell, cell.family.make_weights(cell, SEED, CPU), pool, CPU)
    ref = check.reference_model(cell, weights, CPU).eval()
    with torch.no_grad():
        cls = torch.sigmoid(ref.cls_logit(frame))[frame.mask1]
    moving = float((cls > args["mov_thres"]).float().mean())
    assert abs(moving - share) <= 2.0 / cls.numel(), moving
    prog = Track4D(**args, device=CPU)
    prog.load_state_dict(weights)
    assert torch.equal(prog.state_dict()[CLS_BIAS], weights[CLS_BIAS])


@pytest.mark.parametrize("name", MOVING_CELLS)
def test_run_with_no_moving_point_is_not_correct(name, monkeypatch):
    """Where no point scores above the threshold, the reference clusters
    nothing and the run compares no cluster: not correct."""
    def far_below(*args):
        w = place_motion_threshold(*args)
        return dict(w, **{CLS_BIAS: w[CLS_BIAS] - 100.0})
    monkeypatch.setattr(seeded, "place_motion_threshold", far_below)
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

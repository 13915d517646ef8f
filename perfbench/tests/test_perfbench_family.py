"""The model family: a configuration names it, and the harness reaches
the model only through it.

A second family, `flow` (perfbench/tests/flow/: a small scene-flow model
with its own plain reference), enters through new files alone and runs
through harness.run_cell on the CPU, loading no JAX; the generic tests
(test_perfbench_runs.py) run it as they run RaTrack's cells: correct,
its control and each of its faults not correct. RaTrack's family gives,
on each cell's tiny cut, the same work counts, FLOPs and compared
numbers as the harness gave before the family existed: the values below,
read from that tree with one thread at the same seed, block and inputs.
The counts are integers and compared exactly; the compared numbers are
float32 gaps, compared to a millionth of each. Both come from the
reference's float32 arithmetic on the CPU (its selections decide the
counts), so they hold on the CPU image they were read on; another
instruction set may round them elsewhere."""

import hashlib
import math
import subprocess
import sys
import time

import pytest
import torch

from perfbench import harness, spec, traffic
from perfbench.tests.tiny import CPU, FLOW, SEED, full_cell, kind, tiny_cell


def flow_cell() -> spec.Cell:
    return full_cell("flow_tiny")


def flow_run() -> dict:
    return harness.run_cell(flow_cell(), SEED, 1.0, False, CPU,
                            time.perf_counter())


def test_second_family_run_is_correct():
    """Its configuration, family, mix, workload and entry are new files
    under tests/flow/ that the loader is pointed at; nothing under
    perfbench/ outside the tests names the family."""
    cell = flow_cell()
    assert cell.family.__file__ == str(FLOW / "families" / "flow.py")
    outside = [spec.ROOT / "BENCHMARK.json"] + [
        f for f in spec.HERE.rglob("*")
        if f.suffix in (".py", ".json")
        and "tests" not in f.relative_to(spec.HERE).parts]
    for f in outside:
        text = f.read_text()
        assert not any(w in text for w in ("tests/flow", "tests.flow",
                                           "flow_tiny", "flow_eval")), f
    assert set(cell.config["model"]) == set(cell.family.MODEL_KEYS)
    res = flow_run()
    assert res["correct"], res["check"]
    assert list(res["check"]) == ["flow_gap"]
    assert res["attempted"] > 0
    assert set(res["metrics"]) == {"eval_frames_per_s", "setup_s"}


def test_second_family_run_loads_no_jax():
    code = f"""
import sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {str(spec.ROOT)!r})
from perfbench.tests.test_perfbench_family import flow_run
from perfbench import harness
assert flow_run()["correct"]
print(harness.forbidden_modules())
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


# ---- RaTrack's family against the harness before it ------------------------

J = 1     # the traced block

# per layer: [calls, [bytes, product ops, other ops] summed, sha256 of the
# list's repr, first 16 digits]
SA_EVAL_512 = [27, [7423488, 1005351936, 41046382], "79b556c6309eb3d2"]
SA_EVAL_256 = [27, [4435200, 240334336, 12642684], "188afeb8f500f235"]
SA_TRAIN = [72, [25053696, 4771676160, 507248640], "8d787064b061f010"]
CV_TRAIN = [16, [70700800, 13380354048, 128450560], "286d8658095c35a8"]
TRAIN_NUMBERS = {
    "loss_gap_step1": 0.00024791894666303173,
    "grad_gap": 0.32282513072903524,
    "change_gap_median": 0.005632370351374502,
    "loss_gap_steps": 0.03907759301163194,
    "grad_gap_median": 0.016742893722237816,
    "change_gap_worst": 0.2725540563344067}
PARENT = {
    "eval_vod512_b32": dict(
        work={"set_abstraction": SA_EVAL_512, "cost_volume": [
            8, [7476480, 4434952192, 44564480], "0d85a6c6ea4590de"]},
        flops=2099178240,
        numbers={"cls_gap": 0.0005117058753967285,
                 "warp_gap": 0.008701324462890625,
                 "label_mismatch": 0.3333333134651184,
                 "track_mismatch": 0.0, "conf_gap": 0.00174713134765625,
                 "unclustered": 0.0}),
    "eval_stretch8k_b4": dict(
        work={"set_abstraction": SA_EVAL_256, "cost_volume": [
            8, [12770560, 8869904384, 94371840], "742ba16257aa57bb"]},
        flops=3010694656,
        numbers={"cls_gap": 0.000559687614440918,
                 "warp_gap": 0.007068634033203125,
                 "label_mismatch": 0.0, "track_mismatch": 0.0,
                 "conf_gap": 0.0012505650520324707, "unclustered": 0.5}),
    "train_vod512_b8": dict(
        work={"set_abstraction": SA_TRAIN, "cost_volume": CV_TRAIN},
        flops=6297534720, numbers=TRAIN_NUMBERS),
    "train_vod512_dp4": dict(
        work={"set_abstraction": SA_TRAIN, "cost_volume": CV_TRAIN},
        flops=6297534720, numbers=TRAIN_NUMBERS),
}
# the stretch cut's slice with the split correlator (SPLIT_ABOVE 128)
PARENT_SPLIT = {"set_abstraction": SA_EVAL_256, "cost_volume": [
    16, [14179584, 8869904384, 92487680], "a954d57346789959"]}


@pytest.fixture
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _digest(work: dict) -> dict:
    return {k: [len(v), [sum(x[i] for x in v) for i in range(3)],
                hashlib.sha256(repr(v).encode()).hexdigest()[:16]]
            for k, v in work.items()}


@pytest.mark.parametrize("name", list(PARENT))
def test_ratrack_counts_are_the_parents(name, one_thread, monkeypatch):
    cell = tiny_cell(name)
    kind_, fam = kind(cell), cell.family
    pool = traffic.make_pool(cell.traffic, SEED, CPU)
    frames = min(cell.workload["trace_frames"], cell.traffic["block_frames"])
    assert _digest(fam.slice_work(cell, pool, J, frames, kind_)) == (
        PARENT[name]["work"])
    assert fam.flops_per_frame(cell, kind_) == PARENT[name]["flops"]
    if name == "eval_stretch8k_b4":
        monkeypatch.setattr(fam, "SPLIT_ABOVE", 128)
        assert _digest(fam.slice_work(cell, pool, J, frames, kind_)) == (
            PARENT_SPLIT)


@pytest.mark.parametrize("name", list(PARENT))
def test_ratrack_numbers_are_the_parents(name, one_thread):
    """The weights the run starts from, the compared frames of block J
    (training: the first three of block 0) and, as the program's
    outputs, the control's."""
    cell = tiny_cell(name)
    kind_, fam = kind(cell), cell.family
    pool = traffic.make_pool(cell.traffic, SEED, CPU)
    weights = fam.prepare(cell, fam.make_weights(cell, SEED, CPU), pool, CPU)
    if kind_ == "eval":
        fr = traffic.block(pool, J, cell.traffic["block_frames"])
        fr = traffic.FrameBatch(*[x[:, :cell.workload["check"]["frames"]]
                                  for x in fr])
    else:
        fr = traffic.block(pool, 0, cell.traffic["block_frames"])
        fr = traffic.FrameBatch(*[x[:, :3] for x in fr])
    prog = fam.reference(kind_, cell, weights, fr, control=True)
    got = harness.numbers(cell, kind_, weights, fr, prog)
    want = PARENT[name]["numbers"]
    assert list(got) == list(want)
    assert all(math.isclose(got[k], want[k], rel_tol=1e-6) for k in want), (
        got)

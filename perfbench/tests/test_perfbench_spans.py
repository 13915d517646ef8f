"""The span readers (perfbench/spans.py and the metrics that use it) on a
hand-made slice, and on the tiny traced run of each one-card cell on the
CPU."""

import time
from types import SimpleNamespace

import pytest

from perfbench import harness, spans, spec
from perfbench.tests.tiny import CPU, SEED, tiny_cell
from perfbench.trace import Slice

NEW = [m["name"] for m in spec.benchmark()["per_layer"]
       if m["name"].startswith(("host_ms.", "launches.",
                                "idle_in_layers_pct."))]


def _slice():
    """Two eval frame steps of one stream (times in us):

    host   head [0, 10] with a nested head [2, 4]; head again [8, 20]
           (overlapping: the union is [0, 20]); sinkhorn [30, 40]
    calls  launches at 1, 9 and 15 (head), 35 (sinkhorn), 25 (outside);
           a cudaMemcpyAsync at 5 is no launch
    device kernels [3, 6], [21, 24], [36, 38], [50, 52]: gaps [6, 21]
           (starts in head), [24, 36] (outside), [38, 50] (in sinkhorn)
    """
    host = [("ratrack.head", 0, 10), ("ratrack.head", 2, 4),
            ("ratrack.head", 8, 20), ("ratrack.sinkhorn", 30, 40),
            ("bench.dispatch", 0, 60), ("aten::add", 1, 2)]
    host += [("cudaLaunchKernel", t, t + 0.5) for t in (1, 9, 15, 25)]
    host += [("cuLaunchKernel", 35, 35.5), ("cudaMemcpyAsync", 5, 6)]
    kernels = [(f"k{i}", s, e) for i, (s, e) in
               enumerate([(3, 6), (21, 24), (36, 38), (50, 52)])]
    return Slice(wall_s=60e-6, frames=2, frame_steps=2, kernels=kernels,
                 device_ops=list(kernels), host_ops=host)


def _run(sl, kind="eval"):
    return SimpleNamespace(slice=sl, kind=kind)


def test_nested_and_repeated_spans_count_once():
    sl = _slice()
    assert spans.union(sl, ("head",)) == [(0, 20)]
    assert spans.host_s(sl, ("head",)) == pytest.approx(20e-6)
    assert spans.host_s(sl, ("head", "association")) == pytest.approx(30e-6)
    assert spans.host_s(sl, ("decoder",)) is None
    # ms a frame step
    assert spec.metric_reader("host_ms.head.eval")(_run(sl)) == (
        pytest.approx(1e-2))


def test_launch_calls_count_inside_spans_only():
    sl = _slice()
    assert spans.launches(sl, ("head",)) == 3
    assert spans.launches(sl, ("association",)) == 1
    assert spans.launches(sl, ("head", "association")) == 4
    # a stream-frame, as launches_per_frame
    assert spec.metric_reader("launches.head.eval")(_run(sl)) == 1.5
    assert spec.metric_reader("launches.association.eval")(_run(sl)) == 0.5


def test_idle_gaps_go_to_the_span_they_start_in():
    sl = _slice()
    assert spans.idle_in(sl, ("head",)) == pytest.approx((15e-6, 39e-6))
    assert spans.idle_in(sl, ("association",)) == pytest.approx(
        (12e-6, 39e-6))
    assert spec.metric_reader("idle_in_layers_pct.eval")(_run(sl)) == (
        pytest.approx(100.0 * 27 / 39))


@pytest.mark.parametrize("name", NEW)
def test_readers_read_none_without_kernels_spans_or_kind(name):
    """No kernel (the CPU), no span of the program (a program without
    them), another kind of run, no traced slice: None, never a raise."""
    read = spec.metric_reader(name)
    kind = name.rsplit(".", 1)[1]
    sl = _slice()
    assert read(_run(Slice(sl.wall_s, 2, 2, [], [], sl.host_ops),
                     kind)) is None
    bare = [o for o in sl.host_ops if not o[0].startswith("ratrack.")]
    assert read(_run(Slice(sl.wall_s, 2, 2, sl.kernels, sl.device_ops,
                           bare), kind)) is None
    assert read(_run(sl, "train" if kind == "eval" else "eval")) is None
    assert read(_run(None, kind)) is None


def test_a_new_metric_for_each_layer_of_each_kind():
    names = set(NEW)
    for kind, layers in spans.STEP_LAYERS.items():
        assert f"idle_in_layers_pct.{kind}" in names
        for layer in layers:
            # the host only enqueues the all-reduce: its wait is
            # allreduce_ms_per_step.dp
            if layer != "allreduce":
                assert f"host_ms.{layer}.{kind}" in names
    assert "host_ms.association.train" in names
    assert {f"launches.{layer}.eval"
            for layer in spans.STEP_LAYERS["eval"]} <= names


@pytest.mark.parametrize("name", ["eval_vod512_b32", "train_vod512_b8"])
def test_tiny_traced_run_holds_every_layer(name):
    """The tiny traced run on the CPU holds every layer of its kind that
    a host_ms reader reads: host time in each. Its readers read None
    there, for the slice holds no kernel."""
    m = harness.run_program(tiny_cell(name), SEED, 1.0, True, CPU,
                            time.perf_counter())
    run, sl = m.run, m.run.slice
    readers = [n for n in NEW if n.startswith("host_ms.")
               and n.endswith("." + run.kind)]
    assert readers
    for n in readers:
        layer = n.split(".")[1]
        assert spans.host_s(sl, (layer,)) > 0.0, layer
        assert spec.metric_reader(n)(run) is None
    step = spans.host_s(sl, spans.STEP_LAYERS[run.kind])
    assert 0.0 < step <= sl.wall_s

"""The port's spans (`ratrack_tpu_torch/trace.py`), on the CPU at a tiny
size: without a profiler no span opens a `record_function`; under
`torch.profiler` every path emits each layer's span as often as its frame
step enters the layer; outputs and train state are bitwise the same with
the profiler on and off; and the names in the package, in `SPANS` and in
the traces agree.

Paths: the cached scan (both heads at a block's first frame, one head a
frame after), the uncached scan, the pipelined step (each stage once a
block, the GRU and the ids once a frame), serving's model step, the
train scan (one step a frame) and FLOT's scan (a graph and the features
of both clouds at a block's first frame, of one after)."""

import ast
import collections
import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ratrack_tpu_torch import trace
from ratrack_tpu_torch.data.frames import FrameBatch
from ratrack_tpu_torch.data.synthetic import stack_frames, synthetic_clip
from ratrack_tpu_torch.models.flot import FLOT
from ratrack_tpu_torch.models.track4d import Track4D
from ratrack_tpu_torch.serve import RadarTracker
from ratrack_tpu_torch.tracker.state import init_state
from ratrack_tpu_torch.train import step as step_mod

N, K, B, T = 48, 6, 2, 3
PACKAGE = pathlib.Path(trace.__file__).parent


def _model():
    return Track4D(npoint=N, k_max=K, sinkhorn_iters=4, dbscan_max_iters=3,
                   generator=torch.Generator().manual_seed(3), device="cpu")


def _frames():
    clips = [stack_frames(synthetic_clip(40 + s, T, n_max=N, g_max=6,
                                         n_static=24, n_objects=2,
                                         pts_per_obj=6)) for s in range(B)]
    return FrameBatch(*[torch.as_tensor(np.stack(x)) for x in zip(*clips)])


def _full_frames():
    """`_frames` with every point valid, as FLOT takes them."""
    clips = [stack_frames(synthetic_clip(40 + s, T, n_max=N, g_max=6,
                                         n_static=N - 12, n_objects=2,
                                         pts_per_obj=6)) for s in range(B)]
    return FrameBatch(*[torch.as_tensor(np.stack(x)) for x in zip(*clips)])


def _state():
    return init_state(B, K, 5, 128, device="cpu")


def _serve(model, frames):
    svc = RadarTracker(model, n_max=N, max_streams=B)
    sids = [svc.open_stream() for _ in range(B)]
    outs = []
    for t in range(T):
        for b, sid in enumerate(sids):
            valid = frames.mask1[b, t].numpy()
            scan = np.concatenate([frames.pc1[b, t].numpy(),
                                   frames.ft1[b, t].numpy()], axis=-1)
            svc.submit(sid, scan[valid])
        outs.append(svc.step())
    return {(t, sid, f): getattr(o, f) for t, res in enumerate(outs)
            for sid, o in res.items() for f in ("labels", "track_id", "flow")}


def _train(model, frames):
    ts = step_mod.create_train_state(model, step_mod.TrainConfig(), 10,
                                     device="cpu")
    _, items = step_mod.make_scan_train_step(ts)(_state(), frames, False)
    moments = {f"adam.{i}.{k}": v for i, st in
               ts.optimizer.state_dict()["state"].items()
               for k, v in st.items()}
    return {**{f"item.{k}": v for k, v in items.items()},
            **{f"param.{k}": v for k, v in model.state_dict().items()},
            **moments}


PATHS = {
    "cached": lambda m, f: step_mod.make_scan_eval_step_cached(m)(_state(),
                                                                  f)[1],
    "uncached": lambda m, f: step_mod.make_scan_eval_step(m)(_state(), f)[1],
    "pipelined": lambda m, f: step_mod.make_pipelined_eval_step(m)(
        _state(), f)[1],
    "serve": _serve,
    "train": _train,
    "flot": lambda m, f: step_mod.make_scan_flow_step_cached(m)(f),
}
# each path's span counts: a frame step of the scans enters the cost
# volume twice (the head features' concatenation, then the correlator's
# own forward), DBSCAN twice (its input's assembly, then `dbscan`), the
# descriptors twice (`cluster_descriptors`, `greedy_gt_match`), the id
# assignment twice (the mutual max, then `assign_ids`) and the decoder
# three times (before, in and after the GRU)
PER_STEP = dict(cost_volume=2, decoder=3, dbscan=2, descriptors=2,
                affinity=1, sinkhorn=1, assign_ids=2)
SERVE_STEPS = T - 1      # a stream's first scan only stages it
EXPECTED = {
    "cached": dict({k: T * v for k, v in PER_STEP.items()}, head=T + 1),
    "uncached": dict({k: T * v for k, v in PER_STEP.items()}, head=2 * T),
    "pipelined": dict(PER_STEP, decoder=2 + T, assign_ids=1 + T, head=2),
    "serve": dict({k: SERVE_STEPS * v for k, v in PER_STEP.items()},
                  head=2 * SERVE_STEPS),
    "train": dict({k: T * v for k, v in PER_STEP.items()}, head=2 * T,
                  forward=T, loss=T, backward=T, optimizer=2 * T),
    "flot": dict(graph=T + 1, setconv=T + 1, transport=T, refine=T),
}


def _run(path, profiled):
    """-> (outputs, Counter of the spans' short names)."""
    if path == "flot":
        model = FLOT(generator=torch.Generator().manual_seed(3), device="cpu")
        frames = _full_frames()
    else:
        model, frames = _model(), _frames()
    if not profiled:
        return PATHS[path](model, frames), collections.Counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = PATHS[path](model, frames)
    return out, collections.Counter(
        e.name[len(trace.PREFIX):] for e in prof.events()
        if e.name.startswith(trace.PREFIX))


@pytest.fixture(scope="module")
def runs():
    """Each path with the profiler on, and with it off."""
    return {p: (_run(p, True), _run(p, False)) for p in PATHS}


def _flat(out):
    """{key: tensor} of a path's outputs."""
    return {str(k): v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in out.items()}


@pytest.mark.parametrize("path", ["cached", "pipelined", "train"])
def test_no_record_function_without_a_profiler(path, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(trace, "record_function", refuse)
    _run(path, profiled=False)
    with trace.span("head"):
        pass


@pytest.mark.parametrize("path", list(PATHS))
def test_each_path_emits_its_layer_spans(path, runs):
    (_, counts), _ = runs[path]
    assert dict(counts) == EXPECTED[path]


@pytest.mark.parametrize("path", list(PATHS))
def test_outputs_bitwise_equal_with_the_profiler_on_and_off(path, runs):
    (on, _), (off, _) = runs[path]
    on, off = _flat(on), _flat(off)
    assert on.keys() == off.keys()
    for k in on:
        assert torch.equal(on[k], off[k]), k


def _span_names_in_package():
    """The names that the package's code passes to `span(...)`."""
    names = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "span"):
                names.add(node.args[0].value)
    return names


def test_every_span_is_listed_and_emitted(runs, monkeypatch):
    assert _span_names_in_package() == set(trace.SPANS)
    emitted = set()
    for (_, counts), _ in runs.values():
        emitted |= set(counts)
    # the two spans no single-process model path enters
    from ratrack_tpu_torch import main
    monkeypatch.setattr(step_mod, "all_reduce_mean_", lambda mesh, ts: None)
    model = _model()
    ts = step_mod.create_train_state(model, step_mod.TrainConfig(), 10,
                                     device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step_mod._reduce_over_mesh(ts, mesh=None)
        assert list(main._timed(iter([1, 2]), [0.0], wait_span=True)) == [
            1, 2]
    emitted |= {e.name[len(trace.PREFIX):] for e in prof.events()
                if e.name.startswith(trace.PREFIX)}
    assert emitted == set(trace.SPANS)


def test_span_refuses_an_unlisted_name():
    with pytest.raises(KeyError):
        trace.span("sinkhorn_loop")


def test_nested_spans_and_a_raising_block_close():
    """A decorated function inside a block of its own name, and a block
    that raises: both spans close, and the profiler records each (the
    block holds an op besides the call: the profiler's event list folds a
    span into its parent of the same name where it is the only child)."""
    @trace.span("dbscan")
    def inner():
        return torch.ones(2) + 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("dbscan"):
            assert inner().sum() == 4
        with pytest.raises(ValueError):
            with trace.span("loss"):
                raise ValueError
    names = [e.name for e in prof.events()]
    assert names.count("ratrack.dbscan") == 2
    assert names.count("ratrack.loss") == 1

"""Spans of the frame step on torch.profiler's timeline.

`span(name)` marks a layer of the frame step as `ratrack.<name>`, by
`torch.profiler.record_function`, while a torch profiler records; then
the span lies on the profiler's clock beside the host's launch calls and
the device's kernels. With no profiler recording it opens nothing: a
`with span(...)` costs one object and a check of the profiler's flag, a
decorated function the check alone. A span synchronises nothing and
launches nothing.

    with span("dbscan"):          # a block
        ...

    @span("sinkhorn")             # a function, on every path that calls it
    def log_optimal_transport_masked(...): ...

Spans of one name may nest (a decorated function called inside a block
of its name); readers take the union of their intervals. A thread that
the program starts itself (the data pipeline's producer) is not
recorded, so its work carries no span.
"""

from __future__ import annotations

import functools

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

PREFIX = "ratrack."

# name -> what its span covers
SPANS = {
    "head": "Track4D.head_stage: one cloud through the PNHead (B1 / B1' "
            "or B9 / B8, B6, B2)",
    "cost_volume": "FeatureCorrelator.forward and the head features' "
                   "concatenation with their masked max (B3, B5 + B4, B10)",
    "decoder": "FlowDecoder.pre_gru, gru_apply and post_gru: the motion "
               "and flow heads, the embedding PNHead, the GRU",
    "dbscan": "dbscan, compact_dbscan and the assembly of their input in "
              "Track4D.output_stage: kernel B12 on the card "
              "(dbscan_labels.launches), the plain version on the CPU",
    "descriptors": "cluster_descriptors and greedy_gt_match",
    "affinity": "Track4D.affinity_stage: the affinity MLP over descriptor "
                "differences",
    "sinkhorn": "log_optimal_transport_masked: the eager loop, its graph "
                "replay, the early exit or kernel B7 (the graph's share: "
                ".replays / (.replays + .eager_on_device))",
    "assign_ids": "assign_ids and the mutual-max matching of "
                  "match_structure",
    "forward": "the train step's model call",
    "loss": "the train step's track4d_loss",
    "backward": "the train step's backward",
    "allreduce": "_reduce_over_mesh: the gradient and batch norm "
                 "all-reduces of a data parallel frame step",
    "optimizer": "zero_grad and optimizer_step (Adam, StepLR)",
    "data_wait": "the CLI's wait for the data pipeline (data_wait_s)",
    # FLOT's frame step (models/flot.py), partitioned by these four
    "graph": "FLOT.graph: the kNN graph of a cloud (B5 at k = 32 above "
             "4 M pairs) and its edge offsets",
    "setconv": "FLOT.features: the feature SetConvs of a cloud",
    "transport": "unbalanced_transport_flow: the normalised features, "
                 "kernel B11 or its plain twin",
    "refine": "FLOT.refine: the refinement SetConvs and the linear layer "
              "on the transport's flow",
}


class span:
    """`with span(name):` or `@span(name)`: the block or each call of the
    function inside `record_function("ratrack." + name)` while a torch
    profiler records. `name` is a key of SPANS. Each `with` takes its own
    `span(...)`."""

    __slots__ = ("name", "_open")

    def __init__(self, name: str):
        if name not in SPANS:
            raise KeyError(f"no span {name!r} in trace.SPANS")
        self.name = PREFIX + name
        self._open = None

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._open = record_function(self.name)
            self._open.__enter__()
        return self

    def __exit__(self, *exc):
        opened, self._open = self._open, None
        if opened is not None:
            opened.__exit__(*exc)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with record_function(name):
                return fn(*args, **kwargs)
        return spanned

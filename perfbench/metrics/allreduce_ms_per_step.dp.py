"""Device milliseconds of NCCL's kernels a frame step on rank 0 in the
traced slice: the gradient and batch norm all-reduces of data parallel
training (ratrack_tpu_torch/parallel/mesh.py)."""

import re

NCCL = re.compile(r"nccl", re.IGNORECASE)


def read(run):
    if run.slice is None or run.cell.chips < 2:
        return None
    seconds = run.slice.kernel_s(lambda name: NCCL.search(name))
    if seconds <= 0.0:
        return None
    return 1e3 * seconds / run.slice.frame_steps

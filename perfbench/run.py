"""The benchmark of ratrack_tpu_torch on NVIDIA GPUs: one run of one cell.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Loads, warms up, measures for --seconds, checks the outputs against the
plain reference, and prints one JSON line last on standard output; the
numbers compared, each beside its limit, are the last lines on standard
error. Exits non-zero, printing no result, where CUDA is missing or has
fewer devices than the cell asks for, or where JAX or the JAX package was
loaded. Caches stay inside the checkout (the kernels' library in
ratrack_tpu_torch/kernels/build/).
"""

import time

T_START, T_WALL = time.perf_counter(), time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if cell.chips > 1:
        from perfbench import ranks
        return ranks.run(cell, args, T_WALL)
    return report(harness.run_cell(cell, args.seed, args.seconds,
                                   bool(args.trace), torch.device("cuda", 0),
                                   T_START))


def report(result: dict) -> int:
    """Print the result, unless JAX or the JAX package was loaded -> the
    exit code."""
    from perfbench import harness
    bad = harness.forbidden_modules()
    if bad:
        print(f"perfbench: loaded {bad}: the run may not import JAX or the "
              f"JAX package", file=sys.stderr)
        return 3
    print(f"perfbench: card {card_line()}", file=sys.stderr)
    for name, row in result["check"].items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())

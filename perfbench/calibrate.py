"""The readings that the check's limits are set from (not part of a run).

    python3 perfbench/calibrate.py --workload <cell> --seeds <n> ...
        --seconds <s> [--controls <k>] [--out <file.jsonl>]

For each seed, in one process: a run of the cell with a window of
`--seconds` (harness.run_program: the same set-up, window and compared
frames as a run of run.py; the window must complete a block that starts
a clip), the program's numbers against the reference, and for the first
`--controls` seeds the control's (the reference with TF32 products)
and, in a training cell, the fault's (the reference's loss over half the
streams, the mean taken over the rest, the reference from weights moved
by about one rounding, a witness of the numbers' own noise, and on
several cards the program with the exchange between the ranks left
out). One JSON line a seed."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell, seed, seconds, dev, controls: bool, mesh=None) -> dict:
    """One seed's row (rank 0; None on the other ranks): the program's
    numbers and, with `controls`, the control's and the faults' that the
    cell's family reads."""
    from perfbench import harness
    fam = cell.family
    t0 = time.perf_counter()
    m = harness.run_program(cell, seed, seconds, False, dev,
                            time.perf_counter(), mesh)
    exchange = None
    if controls and mesh is not None:   # the exchange left out
        with fam.exchange_left_out():
            exchange = harness.run_program(cell, seed, seconds, False, dev,
                                           time.perf_counter(), mesh).prog
    if mesh is not None and mesh.rank != 0:
        return None
    kind, weights, frames = m.run.kind, m.weights, m.frames
    ref = fam.reference(kind, cell, weights, frames)
    row = dict(workload=cell.name, seed=seed, program=harness.numbers(
        cell, kind, weights, frames, m.prog, ref))
    if controls:
        ctl = fam.reference(kind, cell, weights, frames, control=True)
        row["control"] = harness.numbers(cell, kind, weights, frames, ctl,
                                         ref)
        row.update(fam.fault_readings(kind, cell, weights, frames, ref,
                                      seed, exchange))
    row["seconds"] = time.perf_counter() - t0
    return row


def main(argv=None):
    import os
    import torch
    from perfbench import spec
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    mesh = None
    if cell.chips > 1:
        if "RANK" not in os.environ:    # start the ranks, one a card
            from perfbench import ranks
            return ranks.spawn(__file__, sys.argv[1:], cell.chips)
        from ratrack_tpu_torch.parallel.mesh import init_from_env, make_mesh
        dev = init_from_env()
        mesh = make_mesh()
    else:
        dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for i, seed in enumerate(args.seeds):
        row = readings(cell, seed, args.seconds, dev, i < args.controls,
                       mesh)
        if row is None:
            continue
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

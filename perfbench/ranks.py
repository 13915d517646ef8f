"""A cell on several cards: one process a card, joined by NCCL.

`run` (in the process that run.py started) picks a free TCP port on
127.0.0.1, starts one process a card running this file, and waits for
them. Each rank joins the group through
`ratrack_tpu_torch.parallel.mesh.init_from_env` (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and runs the harness on its shard;
rank 0 prints the result, last on standard output, and the numbers
compared on standard error. NCCL_SHM_DISABLE=1 keeps NCCL to NVLink and
out of /dev/shm. No tensor passes between the processes but through
NCCL.
"""

import argparse
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

RANK_SECONDS = 1200      # a rank that has not ended by then is stopped


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(cell, args, started: float) -> int:
    """Start cell.chips ranks of `args` and wait -> the exit code (the
    first non-zero one of a rank, else 0). `started`: time.time() at the
    start of the run, which set-up counts from."""
    return spawn(__file__, [
        "--workload", args.workload, "--seed", str(args.seed),
        "--seconds", str(args.seconds), "--trace", str(args.trace),
        "--started", repr(started)], cell.chips)


def spawn(script: str, argv: list, chips: int) -> int:
    """One process a card running `script argv` as ranks 0..chips-1 of a
    group on a free port; rank 0 alone writes to standard output -> the
    first non-zero exit code of a rank, else 0."""
    port = free_port()
    procs = []
    for rank in range(chips):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(chips), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), NCCL_SHM_DISABLE="1")
        procs.append(subprocess.Popen(
            [sys.executable, script, *argv], env=env,
            stdout=None if rank == 0 else subprocess.DEVNULL))
    deadline = time.time() + RANK_SECONDS
    codes = []
    try:
        for p in procs:
            codes.append(p.wait(timeout=max(1.0, deadline - time.time())))
    except subprocess.TimeoutExpired:
        codes.append(124)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return next((c for c in codes if c), 0)


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--started", type=float, required=True)
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from perfbench import harness, spec
    from perfbench.run import report
    from ratrack_tpu_torch.parallel.mesh import init_from_env, make_mesh
    t_start = time.perf_counter() - (time.time() - args.started)
    device = init_from_env()
    mesh = make_mesh()
    cell = spec.cell(args.workload)
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, t_start, mesh=mesh)
    if dist.is_initialized():
        dist.destroy_process_group()
    return report(result) if mesh.rank == 0 else 0


if __name__ == "__main__":
    sys.exit(rank_main())

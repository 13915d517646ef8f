"""A cell of BENCHMARK.json cut to a size the CPU runs in seconds: two
streams, 4-frame blocks that each start a clip, the check over 3 frames; clouds
of 128 points (60 static) and 128 centers where the cell's centers are
its points, else of 256 points (150 static), 64 farthest-point centers
and DBSCAN over the 32 best. Every other setting, the limits included,
is the cell's."""

import time

import torch

from perfbench import harness, spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    model = cell.config["model"]
    cell.traffic.update(streams=2, block_frames=4, clip_frames=4, clips=2)
    if model["npoint"] == cell.traffic["n_max"]:
        cell.traffic.update(n_max=128, n_static=60)
        model.update(npoint=128)
    else:
        cell.traffic.update(n_max=256, n_static=150)
        model.update(npoint=64, mov_budget=min(model["mov_budget"], 32))
    if "frames" in cell.workload["check"]:
        cell.workload["check"]["frames"] = 3
    return cell


def run(name: str, trace: bool = False, seed: int = SEED) -> dict:
    """One run of the tiny cell on the CPU, skipping the look for a card."""
    return harness.run_cell(tiny_cell(name), seed, 1.0, trace, CPU,
                            time.perf_counter())

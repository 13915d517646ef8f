"""A cell cut to a size the CPU runs in seconds, by its family's `tiny`
(for RaTrack: two streams, 4-frame blocks that each start a clip, the
check over 3 frames, clouds of 128 or 256 points). Every other setting,
the limits included, is the cell's.

The cells are BENCHMARK.json's and those of the test-only family `flow`
(tests/flow/bench.json, its files found under tests/flow/), so that the
generic tests run a second family as they run RaTrack's."""

import time

import torch

from perfbench import harness, spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11
FLOW = spec.HERE / "tests" / "flow"
# (the benchmark's data, where its mixes, workloads, entries and families
# lie)
BENCHES = [(spec.benchmark(), spec.HERE),
           (spec.read_json(FLOW / "bench.json"), FLOW)]


def one_card_cells() -> list:
    """Every cell on one device; the four-card cell:
    test_perfbench_ranks.py."""
    return [w["name"] for bench, _ in BENCHES for w in bench["workloads"]
            if w["chips"] == 1]


def full_cell(name: str) -> spec.Cell:
    """The cell `name` as its benchmark file states it."""
    for bench, home in BENCHES:
        if any(w["name"] == name for w in bench["workloads"]):
            return spec.cell(name, bench, home)
    raise KeyError(name)


def tiny_cell(name: str) -> spec.Cell:
    cell = full_cell(name)
    return cell.family.tiny(cell)


def kind(cell: spec.Cell) -> str:
    """"eval" or "train": the kind of the cell's entry."""
    return spec.entry_module(cell.workload["entry"], cell.home).Entry.kind


def run(name: str, trace: bool = False, seed: int = SEED) -> dict:
    """One run of the tiny cell on the CPU, skipping the look for a card."""
    return harness.run_cell(tiny_cell(name), seed, 1.0, trace, CPU,
                            time.perf_counter())

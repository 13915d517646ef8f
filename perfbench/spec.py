"""The benchmark's data: BENCHMARK.json and the files it names.

Everything that belongs to one configuration, cell or per-layer metric is
a file of its own, found by the name BENCHMARK.json gives it:

  configs/<config>.json     the model's family, its constructor arguments
                            and dtype
  families/<family>.py      the model-specific part of a run (below)
  mixes/<traffic>.json      streams, block length, clip and cloud sizes
  workloads/<cell>.json     the entry, the traced blocks, the check
  entries/<entry>.py        the program's path that a window drives
  metrics/<metric>.py       the reader of one per-layer metric

A family file, named by the "family" key of a configuration's file,
provides:

  MODEL_KEYS                the keys of the configuration's "model"
  make_weights(cell, seed, device) -> {name: tensor}, drawn from the seed
  prepare(cell, weights, pool, device) -> the weights the run starts from
  reference(kind, cell, weights, frames, control=False) -> the plain
                            reference's outputs or readings on the
                            compared frames; `control`: the control's
  compare(kind, got, ref, weights, frames) -> the check's {name: value}
                            of `got` (the program's or the control's)
  fault_readings(kind, cell, weights, frames, ref, seed, exchange)
                            -> calibrate.py's readings of the faults
                            beyond the control ({} where none)
  exchange_left_out()       (families with cells on several cards) a
                            context in which the program's step leaves
                            out the exchange between the ranks
  slice_work(cell, pool, j, frames, kind) -> the traced slice's kernel
                            work by layer (work.py's tuples)
  KERNELS                   {"<layer>.<kind>": the compiled pattern of
                            the layer's kernel names in the trace}, the
                            time side of its roofline (readers.roofline)
  flops_per_frame(cell, kind) -> the model's FLOPs a stream-frame
  FAULTS                    {name: plant(monkeypatch, kind)}: the faults
                            a cell can have, planted in the program (the
                            benchmark's tests)
  tiny(cell)                the cell cut to a size the CPU runs in seconds
                            (the benchmark's tests)

A second architecture enters as new files only: its configuration, its
family, its reference, mixes, workloads, entries and readers.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    """Import the Python file `path` under the module name `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""
    name: str
    chips: int
    config: dict            # configs/<config>.json
    family: object          # families/<family>.py, the module
    traffic: dict           # mixes/<traffic>.json
    workload: dict          # workloads/<cell>.json
    end_to_end: list        # the end-to-end metrics this cell reports
    per_layer: list         # the per-layer metrics this cell reports
    home: Path = HERE       # where its mixes, workloads, entries and
                            # family lie


def _reported(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict | None = None, home: Path = HERE) -> Cell:
    """The workload `name` of `bench` (BENCHMARK.json), its mixes,
    workloads, entries and family found under `home`."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = read_json(ROOT / conf["file"])
    return Cell(
        name=name, chips=entry["chips"], config=config,
        family=family(config, conf["file"], home),
        traffic=read_json(home / "mixes" / f"{entry['traffic']}.json"),
        workload=read_json(home / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)],
        home=home)


def family(config: dict, file, home: Path = HERE):
    """The module families/<family>.py that the configuration read from
    `file` names; a missing key or file stops the run, naming it."""
    if "family" not in config:
        raise SystemExit(f"{file}: no \"family\" key (the model family, "
                         f"a file families/<family>.py)")
    path = home / "families" / f"{config['family']}.py"
    if not path.is_file():
        raise SystemExit(f"{file}: family {config['family']!r} has no "
                         f"file {path}")
    return load_module(path, f"perfbench_family_{config['family']}")


def entry_module(kind: str, home: Path = HERE):
    return load_module(home / "entries" / f"{kind}.py",
                       f"perfbench_entry_{kind}")


def metric_reader(name: str):
    """The `read(run)` function of metrics/<name>.py."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_")).read

"""The benchmark's data: BENCHMARK.json and the files it names.

Everything that belongs to one configuration, cell or per-layer metric is
a file of its own, found by the name BENCHMARK.json gives it:

  configs/<config>.json     the model's constructor arguments and dtype
  mixes/<traffic>.json      streams, block length, clip and cloud sizes
  workloads/<cell>.json     the entry, the traced blocks, the check
  entries/<entry>.py        the program's path that a window drives
  metrics/<metric>.py       the reader of one per-layer metric
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
    traffic: dict           # mixes/<traffic>.json
    workload: dict          # workloads/<cell>.json
    end_to_end: list        # the end-to-end metrics this cell reports
    per_layer: list         # the per-layer metrics this cell reports


def _reported(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, bench: dict | None = None) -> Cell:
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"],
        config=read_json(ROOT / conf["file"]),
        traffic=read_json(HERE / "mixes" / f"{entry['traffic']}.json"),
        workload=read_json(HERE / "workloads" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reported(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reported(m, name)])


def entry_module(kind: str):
    return load_module(HERE / "entries" / f"{kind}.py",
                       f"perfbench_entry_{kind}")


def metric_reader(name: str):
    """The `read(run)` function of metrics/<name>.py."""
    return load_module(HERE / "metrics" / f"{name}.py",
                       "perfbench_metric_" + name.replace(".", "_")).read

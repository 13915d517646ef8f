"""BENCHMARK.json and the files it names: every configuration, family,
mix, workload, entry and metric reader loads, and the harness finds each
by name; a configuration without a family file stops the run, naming the
file; the run refuses a machine without a card."""

import json
import subprocess
import sys

import pytest

from perfbench import spec

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load(name):
    cell = spec.cell(name)
    assert set(cell.config["model"]) == set(cell.family.MODEL_KEYS)
    assert cell.traffic["streams"] >= 1
    assert spec.entry_module(cell.workload["entry"]).Entry.kind in (
        "eval", "train")
    assert cell.workload["check"]["limits"]
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_readers_load(name):
    assert callable(spec.metric_reader(name))


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            assert json.load(f)["reduced"] == c["reduced"]


@pytest.mark.parametrize("family", [None, "no_such_family"])
def test_config_without_a_family_file_stops(tmp_path, family):
    """A configuration with no "family" key, or one that names a family
    with no file, stops the run with an error that names the file."""
    bench = spec.benchmark()
    conf = dict(bench["configs"][0])
    config = spec.read_json(spec.ROOT / conf["file"])
    config.pop("family")
    if family is not None:
        config["family"] = family
    conf["file"] = str(tmp_path / "config.json")
    with open(conf["file"], "w") as f:
        json.dump(config, f)
    bench["configs"] = [conf]
    cell = next(w["name"] for w in bench["workloads"]
                if w["config"] == conf["name"])
    with pytest.raises(SystemExit) as err:
        spec.cell(cell, bench)
    assert conf["file"] in str(err.value)
    if family is not None:
        assert str(spec.HERE / "families" / f"{family}.py") in str(err.value)


def test_run_refuses_without_a_card():
    """On a machine with no CUDA device the run exits non-zero and prints
    no result."""
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(spec.HERE / "run.py"), "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=spec.ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""

"""What the benchmark loads: a run loads no module whose top-level name is
jax, jaxlib, flax or ratrack_tpu (compared whole: ratrack_tpu_torch is
the program), and the reference loads nothing of the program."""

import subprocess
import sys

from perfbench import harness, spec

RUN_IMPORTS = """
import sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from perfbench.tests.tiny import run
from perfbench import harness
res = run({cell!r}, trace=True)
print(harness.forbidden_modules())
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""

REFERENCE_IMPORTS = """
import sys
sys.path.insert(0, {root!r})
import perfbench.reference.model, perfbench.reference.losses
import perfbench.reference.control, perfbench.check
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def _python(code):
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=spec.ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout.strip().splitlines()


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("ratrack_tpu_torch_probe", sys)
    assert "ratrack_tpu_torch_probe" not in harness.forbidden_modules()
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "ratrack_tpu")


def test_a_run_loads_no_jax():
    for cell in [w["name"] for w in spec.benchmark()["workloads"]
                 if w["chips"] == 1]:
        forbidden, top = _python(RUN_IMPORTS.format(root=str(spec.ROOT),
                                                    cell=cell))[-2:]
        assert forbidden == "[]"
        assert "'ratrack_tpu_torch'" in top


def test_reference_loads_nothing_of_the_program():
    (top,) = _python(REFERENCE_IMPORTS.format(root=str(spec.ROOT)))[-1:]
    names = set(eval(top))
    assert not names & {"ratrack_tpu_torch", "ratrack_tpu", "jax",
                        "jaxlib", "flax"}

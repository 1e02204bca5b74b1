"""No run loads JAX or the JAX package (compared by whole top-level
names: ``sduss_tpu_torch`` begins with ``sduss_tpu`` and is allowed), and
the reference loads nothing of the program.  Each check runs in a fresh
interpreter."""

import json
import subprocess
import sys

from perfbench.lib.spec import ROOT

RUN_TINY = """
import json, sys, time, torch
from perfbench import run
from perfbench.tests import tiny
out = run.run_cell(tiny.cell(), 5, 1.0, True, torch.device("cpu"),
                   time.perf_counter())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""

REFERENCE = """
import json, sys
import perfbench.reference.models, perfbench.reference.euler
import perfbench.lib.weights, perfbench.work.parts
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    mods = top_level(RUN_TINY)
    assert "sduss_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "sduss_tpu"}


def test_reference_loads_nothing_of_the_program():
    mods = top_level(REFERENCE)
    assert not mods & {"jax", "jaxlib", "flax", "sduss_tpu",
                       "sduss_tpu_torch"}


def test_forbidden_check_compares_whole_names():
    from perfbench import run

    assert run.forbidden_modules(["sduss_tpu_torch.engine", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "torch"]) == ["jax"]
    assert run.forbidden_modules(["sduss_tpu.engine"]) == ["sduss_tpu"]

"""The port stands alone: importing every module of ``sduss_tpu_torch`` and
``chip_smoke.py`` loads neither jax nor any module of the JAX package.

Runs in a fresh interpreter, since this test process has both loaded.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_nothing_of_jax_or_sduss_tpu():
    code = textwrap.dedent("""
        import importlib, importlib.util, pkgutil, sys
        import sduss_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            sduss_tpu_torch.__path__, "sduss_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        # the benchmark harness, the dispatcher and the dp placement too
        assert {"sduss_tpu_torch.benchmark.replay",
                "sduss_tpu_torch.benchmark.traces",
                "sduss_tpu_torch.benchmark.metrics",
                "sduss_tpu_torch.dispatcher",
                "sduss_tpu_torch.parallel.replica"} <= set(names), names
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "sduss_tpu" or m.startswith("sduss_tpu."))
        assert not bad, bad
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    # the walk found the package's modules (ops, models, scheduler, ...)
    assert int(proc.stdout.strip().splitlines()[-1]) >= 25


def test_serving_front_needs_no_aiohttp_nor_pillow():
    """The HTTP server and client run on the standard library: importing
    them loads neither aiohttp nor PIL (the card's machine has neither),
    nor jax or the JAX package."""
    code = textwrap.dedent("""
        import sys
        import sduss_tpu_torch.entrypoints.api_server
        import sduss_tpu_torch.entrypoints.client
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("aiohttp", "PIL", "jax",
                                            "jaxlib", "sduss_tpu"))
        assert not bad, bad
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"

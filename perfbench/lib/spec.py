"""What a run reads by name: ``BENCHMARK.json``, the cell, its
configuration file, its traffic mix, its correctness limits, and the
reader of each per-layer metric.  Everything is found from the names in
``BENCHMARK.json``, so a later change adds a cell, a mix or a metric as
files and entries and edits none of these."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


def load_benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    with open(path) as f:
        return json.load(f)


def config_file(name: str) -> dict:
    return _json(BENCH_DIR / "configs" / f"{name}.json")


def traffic_file(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def metric_applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its files: ``configs[].file``,
    ``perfbench/traffic/<traffic>.json`` and
    ``perfbench/limits/<cell>.json``."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return Cell(
        name=name,
        config=_json(root / conf["file"]),
        traffic=traffic_file(wl["traffic"]),
        chips=int(wl["chips"]),
        end_to_end=[m for m in bench["end_to_end"]
                    if metric_applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if metric_applies(m, name)],
        limits=_json(BENCH_DIR / "limits" / f"{name}.json"))


def reader(metric_name: str) -> Callable:
    """The ``read(run)`` function of a per-layer metric:
    ``perfbench/metrics/<name>.py``, else the file of its base name (the
    part before the first dot), which serves every suffix of it."""
    for stem in (metric_name, metric_name.split(".", 1)[0]):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"perfbench_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for per-layer metric {metric_name!r}")


def work_module(mode: str):
    """``perfbench/work/<mode>.py``: the work a step of that mode needs."""
    path = BENCH_DIR / "work" / f"{mode}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no work functions for step mode {mode!r}")
    spec = importlib.util.spec_from_file_location(f"perfbench_work_{mode}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def limits_of(c: Cell) -> Dict[str, float]:
    return {k: float(v["limit"]) for k, v in c.limits["numbers"].items()}


def check_chips(need: int) -> Optional[str]:
    """Why the run cannot go on, or None: a card count below the cell's."""
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < need:
        return (f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                f"{need}")
    return None

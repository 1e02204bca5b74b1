"""Run one cell of the benchmark of ``sduss_tpu_torch`` on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (process start to the end of the engine's prewarm), the cell's
traffic through ``AsyncEngine.generate``, the measured window, the drain,
then the check of the sampled requests against the plain reference.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number with its limit,
also the last lines of standard error).  ``--control`` judges the float8
control in the program's place (``correct`` then has to read false).  Without a CUDA card, or with
fewer cards than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "sduss_tpu")


def cache_env() -> None:
    """Every kernel cache at a fixed path inside the checkout; no library
    pulls JAX in."""
    cache = ROOT / "build" / "perfbench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    return sorted({m.split(".")[0] for m in (names or list(sys.modules))}
                  & set(FORBIDDEN))


class Run:
    """What the per-layer readers see."""

    def __init__(self, served, mix, cfg, trace, work):
        self.served, self.mix, self.cfg = served, mix, cfg
        self.trace, self.work = trace, work


def end_to_end(cell, served) -> tuple:
    from perfbench.lib import window

    m = window.closed_loop(served.records, served.w0, served.w1)
    m["setup_s"] = served.setup_s
    return m


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="judge the float8 control in the program's place "
                         "(its numbers decide correct; not for the "
                         "benchmark's own runs)")
    args = ap.parse_args(argv)
    cache_env()
    from perfbench.lib import spec

    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if cell.traffic["loop"] != "closed":
        # an open loop's metrics, readers and sample land with its cell
        print("perfbench: only closed-loop cells run here; no result",
              file=sys.stderr)
        return 2
    why = spec.check_chips(cell.chips)
    if why is not None:
        print(f"perfbench: {why}; no result", file=sys.stderr)
        return 2
    import torch

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START, control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}; no result",
              file=sys.stderr)
        return 3
    emit(result)
    return 0


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> dict:
    """One run of ``cell``; returns the result object (``checks`` last)."""
    import torch

    from perfbench.lib import check, serve, spec

    run_dir = ROOT / ".perfbench_runs"
    run_dir.mkdir(exist_ok=True)
    served = serve.serve(cell, seed, seconds, trace, device, t_start,
                         str(run_dir))
    e2e = end_to_end(cell, served)
    print(f"perfbench: lead-in {served.lead_in_s:.1f} s, window "
          f"{served.w1 - served.w0:.3f} s, setup {served.setup_s:.3f} s, "
          f"{e2e['attempted']} attempted, {e2e['failed']} failed, "
          f"{len(served.probe.steps)} denoise steps", file=sys.stderr)
    why = collections.Counter(r.error for r in served.records if not r.ok)
    if why:
        print(f"perfbench: failures by reason {dict(why)}", file=sys.stderr)
    served.probe.pipe = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
    trace_sum = work = None
    if trace:
        from perfbench.lib import account, trace as tr

        kernels = served.tracer.kernels()
        off = served.tracer.offset_ns
        spans = [(k, a * 1e9 + off, b * 1e9 + off)
                 for k, a, b, _ in served.probe.spans]
        active = [(r.sent * 1e9 + off,
                   (r.done or r.given_up or served.w1) * 1e9 + off)
                  for r in served.records]
        trace_sum = tr.reduce(kernels, served.w0 * 1e9 + off,
                              served.w1 * 1e9 + off, spans, active)
        work = account.window_work(cell.config, served.probe, served.w0,
                                   served.w1, _boundary(cell))
    limits = spec.limits_of(cell)
    checks, correct, judged = {}, False, None
    try:
        judged = check.judge(cell.config, cell.limits, served, seed, device,
                             _boundary(cell), control=control)
        print("perfbench: program " + json.dumps(judged["numbers"])
              + f", widest drift-score gap (log) {judged['drift_gap']:.4g}",
              file=sys.stderr)
        # with --control the float8 control stands in the program's place
        nums = judged["control"] if control else judged["numbers"]
        checks = {k: {"value": v, "limit": limits[k]} for k, v in
                  nums.items()}
        correct = (judged["compared"] > 0 and served.engine_error is None
                   and all(v <= limits[k] for k, v in nums.items()))
        checks["compared_requests"] = {"value": judged["compared"],
                                       "limit": 1}
        for err, where in judged["worst"]:
            print(f"perfbench: model output error {err:.4g} at {where}",
                  file=sys.stderr)
    except Exception:  # noqa: BLE001 - a check that cannot run is a failure
        traceback.print_exc()
    if trace:
        metrics = {}
        run = Run(served, cell.traffic, cell.config, trace_sum, work)
        for m in cell.per_layer:
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(served.peak_bytes)}
    out = {"correct": bool(correct), "attempted": e2e["attempted"],
           "failed": e2e["failed"], "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = trace_sum["busy_s"]
        dev["window_s"] = trace_sum["window_s"]
        out["breakdown"] = {"device_ops": trace_sum["device_ops"],
                            "idle_gaps": trace_sum["idle_gaps"]}
        print("perfbench: device time by class "
              + json.dumps(trace_sum["by_class"]) + f", work {work}, "
              f"{trace_sum['n_kernels']} kernels, clocks aligned by marker: "
              f"{getattr(served.tracer, 'aligned', False)}",
              file=sys.stderr)
    if judged is not None and "control" in judged:
        print("perfbench: control " + json.dumps(judged["control"]),
              file=sys.stderr)
    if served.engine_error:
        print(f"perfbench: engine error {served.engine_error}",
              file=sys.stderr)
    out["checks"] = checks
    return out


def _boundary(cell):
    if cell.traffic["cache"] == "production":
        from sduss_tpu_torch.config import CacheConfig

        return CacheConfig.production(cell.config["family"]).deep_boundary
    return None


def _finite(v):
    if isinstance(v, float) and v != v:
        return 1e30
    if isinstance(v, float) and abs(v) == float("inf"):
        return 1e30
    return v


def emit(result: dict) -> None:
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_sanitize(result), allow_nan=False))
    sys.stdout.flush()


def _sanitize(obj):
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_sanitize(v) for v in obj]
    return _finite(obj)


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark harness (counterpart of sduss_tpu/benchmark/): trace
generation, replay against the port's ``AsyncEngine`` and SLO metric
extraction.

The reference's experiment tooling (exp/qps_*.csv traces, the direct-test
replay harness, the metric extraction script) as a package; every module
here runs on numpy and the standard library, apart from ``replay``, which
drives the engine.
"""

from sduss_tpu_torch.benchmark.traces import TraceRow, generate_trace, load_trace, save_trace  # noqa: F401
from sduss_tpu_torch.benchmark.metrics import compute_metrics, slo_deadline_s  # noqa: F401

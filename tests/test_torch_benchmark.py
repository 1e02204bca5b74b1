"""The port's benchmark harness (``sduss_tpu_torch/benchmark/``) against
the JAX package's on CPU.

- ``generate_trace`` gives equal rows for every distribution and seed, and
  the same ``ValueError`` for a non-uniform mix over the wrong number of
  resolutions; ``save_trace`` and ``records_to_csv`` write equal bytes;
  ``load_trace`` reads the committed ``exp/sdxl/qps_1.0.csv`` equally.
- ``slo_deadline_s`` is equal for every family, resolutions in and out of
  the table, slo 3, 5, 7 and 10; ``compute_metrics`` dicts are equal on
  seeded records, with aborts, all aborted and empty.
- A tiny ``run_replay`` (4 requests at 64/128 px, 64 px patches,
  ``time_scale`` 0.05, dp 1 and 2) returns 4 records, no aborts, and
  metrics with JAX's keys; the CLI with ``--tiny --device cpu`` prints
  them.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np
import pytest

from sduss_tpu.benchmark import metrics as jax_metrics
from sduss_tpu.benchmark import traces as jax_traces
from sduss_tpu_torch.benchmark import metrics, replay, traces
from sduss_tpu_torch.entrypoints.offline import default_config
from test_torch_slice import torch_threads  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TRACE = ROOT / "exp" / "sdxl" / "qps_1.0.csv"
RES = (512, 768, 1024)


def rows_of(rows):
    return [dataclasses.astuple(r) for r in rows]


@pytest.mark.parametrize("distribution", sorted(traces.DISTRIBUTIONS))
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_generate_trace_matches_jax(distribution, seed):
    kw = dict(qps=1.5, num_requests=40, resolutions=RES,
              distribution=distribution, steps=30, seed=seed)
    assert traces.DISTRIBUTIONS == jax_traces.DISTRIBUTIONS
    assert rows_of(traces.generate_trace(**kw)) \
        == rows_of(jax_traces.generate_trace(**kw))
    prompts = ["a cat", "a dog", "a fox"]
    assert rows_of(traces.generate_trace(**kw, prompts=prompts)) \
        == rows_of(jax_traces.generate_trace(**kw, prompts=prompts))
    kw["resolutions"] = (256, 512)
    if distribution == "uniform":  # two resolutions, even odds
        assert rows_of(traces.generate_trace(**kw)) \
            == rows_of(jax_traces.generate_trace(**kw))
        return
    with pytest.raises(ValueError) as port_err:
        traces.generate_trace(**kw)
    with pytest.raises(ValueError) as jax_err:
        jax_traces.generate_trace(**kw)
    assert str(port_err.value) == str(jax_err.value)


def test_trace_files_match_jax(tmp_path):
    rows = traces.generate_trace(0.8, 25, RES, "small", seed=3,
                                 prompts=["a, quoted \"cat\"", "plain"])
    traces.save_trace(rows, tmp_path / "port.csv")
    jax_traces.save_trace(jax_traces.generate_trace(
        0.8, 25, RES, "small", seed=3, prompts=["a, quoted \"cat\"", "plain"]),
        tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() \
        == (tmp_path / "jax.csv").read_bytes()
    back = traces.load_trace(tmp_path / "port.csv")
    assert rows_of(back) == rows_of(jax_traces.load_trace(tmp_path / "jax.csv"))
    committed = traces.load_trace(TRACE)
    assert len(committed) == 500
    assert rows_of(committed) == rows_of(jax_traces.load_trace(TRACE))


@pytest.mark.parametrize("family", ["sd15", "sdxl", "sd3"])
def test_slo_deadlines_match_jax(family):
    assert metrics._SLO5_DEADLINES == jax_metrics._SLO5_DEADLINES
    assert metrics._SLO_FACTORS == jax_metrics._SLO_FACTORS
    for res in (64, 256, 512, 640, 768, 1024, 1280, 2048):
        for slo in (3, 5, 7, 10):
            assert metrics.slo_deadline_s(family, res, slo) \
                == jax_metrics.slo_deadline_s(family, res, slo)
    table = {512: 2.0, 1024: 6.0}
    assert metrics.slo_deadline_s(family, 768, 7, table) \
        == jax_metrics.slo_deadline_s(family, 768, 7, table)


def seeded_records(module, n: int, abort_share: float, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        arrival = float(rng.uniform(0, 20))
        out.append(module.RequestRecord(
            f"r{i}", int(rng.choice(RES)), arrival,
            arrival + float(rng.uniform(1, 40)),
            aborted=bool(rng.random() < abort_share)))
    return out


def same_dict(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        (math.isnan(a[k]) and math.isnan(b[k])) or a[k] == b[k] for k in a)


@pytest.mark.parametrize("n,abort_share", [(30, 0.2), (12, 0.0), (5, 1.0),
                                           (0, 0.0)],
                         ids=["aborts", "none-aborted", "all-aborted",
                              "empty"])
def test_compute_metrics_matches_jax(n, abort_share, tmp_path):
    ours = seeded_records(metrics, n, abort_share, seed=n)
    theirs = seeded_records(jax_metrics, n, abort_share, seed=n)
    for family in ("sdxl", "sd3"):
        for slo in (3, 5, 10):
            assert same_dict(metrics.compute_metrics(ours, family, slo),
                             jax_metrics.compute_metrics(theirs, family, slo))
    metrics.records_to_csv(ours, tmp_path / "port.csv")
    jax_metrics.records_to_csv(theirs, tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() \
        == (tmp_path / "jax.csv").read_bytes()
    back = metrics.records_from_csv(tmp_path / "port.csv")
    assert [dataclasses.astuple(r) for r in back] == [
        dataclasses.astuple(r)
        for r in jax_metrics.records_from_csv(tmp_path / "jax.csv")]


def jax_keys() -> set:
    return set(jax_metrics.compute_metrics(
        seeded_records(jax_metrics, 3, 0.0, 0), "sd15"))


@pytest.mark.parametrize("dp", [1, 2])
def test_run_replay_tiny(dp):
    config = default_config("sd15", dtype="float32", test_tiny=True,
                            resolutions=(64, 128))
    config.scheduler.patch_size = 64
    config.parallel.dp = dp
    rows = traces.generate_trace(20.0, 4, (64, 128), steps=2, seed=dp)
    records = replay.run_replay(config, rows, slo=5, time_scale=0.05,
                                device="cpu")
    assert len(records) == 4 and not any(r.aborted for r in records)
    assert sorted(r.request_id for r in records) \
        == [f"replay-{i}" for i in range(4)]
    assert all(r.finish_time > r.arrival_time for r in records)
    got = metrics.compute_metrics(records, "sd15")
    assert set(got) == jax_keys() and got["abort_rate"] == 0.0


def test_replay_cli_on_cpu(capsys, tmp_path):
    out = tmp_path / "client.csv"
    got = replay.main(["--model", "sd15", "--tiny", "--device", "cpu",
                       "--dtype", "float32", "--resolutions", "64",
                       "--num-requests", "2", "--steps", "2", "--qps", "50",
                       "--policy", "fcfs_mixed", "--out", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == set(got) == jax_keys()
    assert printed["num_requests"] == 2
    assert len(metrics.records_from_csv(out)) == 2

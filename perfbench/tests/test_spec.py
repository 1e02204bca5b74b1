"""Discovery by name: every cell finds its configuration, mix and limits,
every per-layer metric its reader, every step mode its work functions;
and BENCHMARK.json keeps to its contract's shape."""

import json
import re

import pytest

from perfbench.lib import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    return spec.load_benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert bench["paths"] == ["perfbench"]
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_resolves(bench):
    for wl in bench["workloads"]:
        assert NAME.match(wl["name"]) and len(wl["why"]) <= 200
        assert wl["chips"] == 1
        c = spec.cell(bench, wl["name"])
        assert c.config["name"] == wl["config"]
        assert c.traffic["loop"] in ("open", "closed")
        assert set(c.limits["numbers"]) >= {"text_err", "eps_full_err",
                                            "eps_cached_err", "euler_err",
                                            "decode_err"}
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert c.per_layer
        for m in c.per_layer:
            assert m["moves"] in e2e


def test_configs_are_used_and_unreduced(bench):
    used = {w["config"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert c["name"] in used and c["reduced"] == []
        with open(spec.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["dtype"] == "bfloat16"


def test_metrics(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in bench["end_to_end"])
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert callable(spec.reader(m["name"]))
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.parametrize("mode", ["full", "shallow", "partial"])
def test_work_modules(mode):
    assert callable(spec.work_module(mode).work)


def test_unknown_names_raise(bench):
    with pytest.raises(KeyError):
        spec.cell(bench, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric.open")

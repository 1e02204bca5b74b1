"""The check works the cache's state out itself: a program that leaves a
cache unrefreshed, or gates its rows other than the preset says, reads
``correct`` false although every model output it returns follows from
what it held.  Tiny SD-1.5 closed-loop runs on the CPU (float32), long
enough for the deep interval to expire and for rows to be reused across
compositions."""

import time

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny

SEED = 2**31 + 5
STEPS = 16


def drive():
    cell = tiny.cell(steps=STEPS, clients=4, sample=4)
    return run.run_cell(cell, SEED, 3.0, False, torch.device("cpu"),
                        time.perf_counter())


def test_sound_run_reuses_and_is_correct(monkeypatch):
    from sduss_tpu_torch.cache.manager import BlockCache

    reused = []
    orig = BlockCache.gate_compact_pairs

    def count(self, key, x, t_norm, state_k, *a, **kw):
        out = orig(self, key, x, t_norm, state_k, *a, **kw)
        reused.append(int((state_k["hits"] > 0).sum()))
        return out

    monkeypatch.setattr(BlockCache, "gate_compact_pairs", count)
    out = drive()
    assert out["correct"], out["checks"]
    assert out["checks"]["cache_rule_miss"]["value"] == 0
    assert sum(reused) > 20


def _skip_row_write_back(mp):
    """A recompute that keeps its hits reset and skips writing its rows."""
    from sduss_tpu_torch.cache.manager import BlockCache

    def splice(self, state_k, x_c, y_c, idx):
        state_k["hits"].add_(1)
        state_k["hits"].index_fill_(0, idx, 0)
        return state_k["out"]

    mp.setattr(BlockCache, "_compact_splice", splice)


def _skip_full_write_back(mp):
    """A full step that leaves the rows of its first write in place."""
    from sduss_tpu_torch.cache.manager import BlockCache

    orig = BlockCache.write_through
    seen = set()

    def write(self, state_k, x, y):
        if id(state_k["out"]) in seen:
            state_k["hits"].zero_()
            return
        seen.add(id(state_k["out"]))
        orig(self, state_k, x, y)

    mp.setattr(BlockCache, "write_through", write)


def _stale_deep_feature(mp):
    """Full and partial steps hand on the first deep feature of their
    bucket, never the one they computed."""
    from sduss_tpu_torch.pipelines.base import BasePipeline

    orig = BasePipeline._deep_step
    first = {}

    def step(self, mode, row_valid, latents, *a):
        new, deep_out = orig(self, mode, row_valid, latents, *a)
        if mode == "shallow":
            return new, deep_out
        kept = first.setdefault(tuple(deep_out.shape), deep_out.clone())
        return new, kept.clone()

    mp.setattr(BasePipeline, "_deep_step", step)


def _gate_stops(mp):
    """After warm-up the gate recomputes nothing and reuses every row."""
    from sduss_tpu_torch.cache.manager import BlockCache

    orig = BlockCache.gate_compact_pairs
    calls = [0]

    def gate(self, key, x, t_norm, state_k, *a, **kw):
        calls[0] += 1
        if calls[0] <= 30:
            return orig(self, key, x, t_norm, state_k, *a, **kw)
        scores = self._scores(key, x, state_k, t_norm)
        state_k["hits"].add_(1)
        return state_k["out"], state_k, {"idx": None, "scores": scores}

    mp.setattr(BlockCache, "gate_compact_pairs", gate)


def _least_drifted_first(mp):
    """The gate ranks rows by the opposite of their drift."""
    from sduss_tpu_torch.cache.manager import BlockCache

    orig = BlockCache._drift_logit

    def logit(self, key, x, state_k, t_norm, reducer=None):
        score, rel = orig(self, key, x, state_k, t_norm, reducer)
        return -score, rel

    mp.setattr(BlockCache, "_drift_logit", logit)


def _deep_interval_ignored(mp):
    """Incumbents never expire: a request refreshes its deep feature only
    in warm-up."""
    from sduss_tpu_torch.pipelines.base import BasePipeline

    orig = BasePipeline._deep_policy

    def policy(self):
        _, warmup, adaptive = orig(self)
        return 10 ** 6, warmup, adaptive

    mp.setattr(BasePipeline, "_deep_policy", policy)


@pytest.mark.parametrize("plant", [_skip_row_write_back,
                                   _skip_full_write_back,
                                   _stale_deep_feature, _gate_stops,
                                   _least_drifted_first,
                                   _deep_interval_ignored],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_is_not_correct(monkeypatch, plant):
    plant(monkeypatch)
    out = drive()
    assert out["checks"]["compared_requests"]["value"] >= 1
    assert not out["correct"], out["checks"]

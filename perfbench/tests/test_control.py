"""The comparison that decides ``correct`` has to fail: the float8
control in the program's place, and a run with the timed path broken
underneath (a step that returns its state unchanged; a model output or
an image altered where it is produced).  Tiny closed-loop cells on the
CPU, past the harness's look for a card; the same control on the card is
``run.py --control``."""

import time

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny

SEED = 2**31 + 77


def drive(cell, **kw):
    return run.run_cell(cell, SEED, 2.0, False, torch.device("cpu"),
                        time.perf_counter(), **kw)


@pytest.fixture(scope="module")
def control():
    return drive(tiny.cell(tiny.SDXL), control=True)


def test_control_is_not_correct(control):
    assert not control["correct"]
    assert control["checks"]["compared_requests"]["value"] >= 1


@pytest.mark.parametrize("number", ["text_err", "eps_full_err",
                                    "eps_cached_err", "euler_err",
                                    "decode_err", "cache_fp_err"])
def test_control_fails_each_number(control, number):
    c = control["checks"][number]
    assert c["value"] > c["limit"], number


@pytest.mark.parametrize("config,cache", [(tiny.SD15, "production"),
                                          (tiny.SDXL, "production"),
                                          (tiny.SD15, "off")],
                         ids=["sd15", "sdxl", "sd15-cache-off"])
def test_closed_loop_dense_path_is_correct(config, cache):
    out = drive(tiny.cell(config, cache=cache))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0


def test_state_left_unchanged_fails(monkeypatch):
    from sduss_tpu_torch.samplers.euler import EulerDiscreteSampler

    monkeypatch.setattr(EulerDiscreteSampler, "step",
                        lambda self, x, *a, **k: x)
    out = drive(tiny.cell())
    assert not out["correct"]
    assert out["checks"]["euler_err"]["value"] > \
        tiny.LIMITS["numbers"]["euler_err"]["limit"]


def test_altered_model_output_fails(monkeypatch):
    from sduss_tpu_torch.pipelines.sdxl import StableDiffusionXLPipeline

    orig = StableDiffusionXLPipeline.denoiser_forward

    def bent(self, *a, **k):
        out = orig(self, *a, **k)
        if isinstance(out, tuple):
            return (out[0] * 1.02,) + tuple(out[1:])
        return out * 1.02

    monkeypatch.setattr(StableDiffusionXLPipeline, "denoiser_forward", bent)
    out = drive(tiny.cell(tiny.SDXL))
    assert not out["correct"]


def test_altered_image_fails(monkeypatch):
    from sduss_tpu_torch.pipelines.base import BasePipeline

    orig = BasePipeline._decode_fn
    monkeypatch.setattr(BasePipeline, "_decode_fn",
                        lambda self, lat: orig(self, lat) // 2)
    out = drive(tiny.cell())
    assert not out["correct"]
    assert out["checks"]["decode_err"]["value"] > 1.0

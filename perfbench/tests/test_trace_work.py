"""The trace reduction on synthetic kernels, the work of each step mode,
and the sweep's knee rule."""

import pytest

from perfbench import sweep
from perfbench.lib import spec, trace
from perfbench.lib.window import Record
from perfbench.tests import tiny
from perfbench.work import parts


def test_reduce_unions_spans_and_names_gaps():
    ks = [("mha_fused_kernel<64, false>", 0, 10), ("gemm", 5, 20),
          ("cross_short_kernel<64>", 50, 60), ("copy", 90, 130)]
    spans = [("denoise", 0, 25), ("decode", 40, 70)]
    active = [(0, 55)]
    r = trace.reduce(ks, 0, 100, spans, active)
    assert r["busy_s"] == pytest.approx(40e-9)
    assert r["window_s"] == pytest.approx(100e-9)
    assert r["attn_device_s"] == pytest.approx(20e-9)
    assert r["idle_gaps"][0] == ["denoise", pytest.approx(30e-9)]
    assert r["idle_gaps"][1] == ["no request in the system (arrivals)",
                                 pytest.approx(30e-9)]
    assert r["by_class"]["matmul"] == pytest.approx(15e-9)


def test_op_classes_first_match():
    assert trace.op_class("mha_fused_kernel<40, true>(__nv_bfloat16 x)") \
        == "masked flash attention"
    assert trace.op_class("sm90_xmma_fprop_implicit_gemm") == "convolution"
    assert trace.is_attention("cross_short_kernel<80>")
    assert not trace.is_attention("gn_halo_kernel")


@pytest.mark.parametrize("res", [64, 128])
def test_modes_add_up(res):
    t = parts.unet(tiny.SDXL, res, 1)
    allp = {k: True for k in t["pairs"]}
    none = {k: False for k in t["pairs"]}
    full = spec.work_module("full").work(t, allp, True)[0]
    sh = spec.work_module("shallow").work(t, allp, False)[0]
    sh0 = spec.work_module("shallow").work(t, none, False)[0]
    pa = spec.work_module("partial").work(t, none, True)[0]
    assert full == pytest.approx(sh + t["tail"])
    assert sh == pytest.approx(sh0 + sum(t["pairs"].values()))
    assert pa == pytest.approx(sh0 + t["tail"])
    assert sh0 > 0 and t["tail"] > sh


def test_attention_work_is_counted_per_part():
    t = parts.unet(tiny.SD15, 64, 1)
    n = sum(len(v) for v in t["attn"].values())
    # tiny SD-1.5: level 0 has one transformer a resnet (self + cross)
    assert n > 0 and t["attn"]["tail"]
    fl, nb = t["attn"]["down0.0"][0]
    assert fl > 0 and nb > 0
    assert parts.attn_bound_s(989e12, 0.0) == pytest.approx(1.0)


def test_knee_rule():
    rs = [Record(i, f"r{i}", 512, float(i), float(i), done=i + 3.0, ok=True)
          for i in range(10)]
    assert sweep.backlog(rs, 5.0) == 3
    m = {"slo_attainment": 0.95, "attempted": 40}
    assert sweep.sustained(m, 3, 5)
    assert not sweep.sustained(m, 3, 10)
    assert not sweep.sustained({"slo_attainment": 0.85, "attempted": 40},
                               3, 3)

"""The replay works out the row caches through composition changes:
requests that alternate between two dense batch compositions carry their
rows from one to the next (a request that joins starts from fresh rows),
and the reference, which keeps its own newest values, stays within
float32 rounding of the program; the program in bf16 stays within its
rounding and breaks no cache rule at the cells' tie margin."""

import time

import torch

from perfbench import run
from perfbench.lib import check, serve, traffic
from perfbench.lib.probe import Probe
from perfbench.tests import tiny

STEPS = 16


def test_alternating_compositions_follow_the_program():
    from sduss_tpu_torch.request import Request, SamplingParams, Stage

    cell = tiny.cell(steps=STEPS)
    config = serve.program_config(cell.config, cell.traffic, False, "")
    eng = serve.build_engine(cell.config, config, 77, torch.device("cpu"))
    pipe = eng.workers[0].pipeline
    probe = Probe(pipe, True)
    items, reqs = {}, {}
    for i, name in enumerate("ACDE"):
        items[name] = traffic.Item(i, 64, STEPS, f"a photo {name}", 10 + i)
        reqs[name] = Request(name, SamplingParams(
            prompt=items[name].prompt, resolution=64,
            num_inference_steps=STEPS, seed=10 + i))
    probe.tracked.update(reqs)
    pipe.prepare(list(reqs.values()))
    for r in reqs.values():
        r.stage = Stage.DENOISING
    three = [reqs[k] for k in "ACD"]
    four = [reqs[k] for k in "ACDE"]
    for comp in [three] * 4 + [four, three] * 5 + [four, four]:
        pipe.denoise_step({64: comp})
    for r in reqs.values():
        while r.remain_steps:
            pipe.denoise_step({64: [r]})
    for r in reqs.values():
        r.stage = Stage.POSTPROCESSING
    pipe.postprocess({64: four})
    probe.remove()

    # rows reused on a step whose composition is new to the request: the
    # program carried them over from the one before
    carried = 0
    for d in probe.tracked_data.values():
        prev = None
        for st in d["steps"]:
            rec, j = st["rec"], st["step_index"]
            if (prev is not None and rec["ids"] != prev
                    and rec["mode"] != "full"):
                carried += sum(int(h[j] != 0) for h in rec["hits"].values())
            prev = rec["ids"]
    assert carried > 0
    rp = check.Replay(cell.config, 77, torch.device("cpu"))
    rp.boundary = 1
    rules = check.Rules(cell.limits["rules"])
    nums = {k: 0.0 for k in check.NUMBERS}
    with torch.inference_mode():
        for name, d in probe.tracked_data.items():
            check.follow(rp, items[name], d, nums, rules)
    assert nums["cache_rule_miss"] == 0, nums
    assert nums["cache_fp_err"] < 1e-4, nums
    assert nums["eps_cached_err"] < 1e-4, nums
    assert nums["eps_full_err"] < 1e-4, nums


def test_bf16_program_is_followed_within_rounding():
    """The program in bf16 against the float32 reference on the dense
    path with reused rows, at the cells' tie margin."""
    # every request sent in the window is sampled: a slow CPU sends few
    cell = tiny.cell(tiny.SD15, tiny.CLOSED, steps=20, clients=8, sample=8)
    cell.config["dtype"] = "bfloat16"
    cell.limits["rules"]["tie_margin"] = 1.0
    out = run.run_cell(cell, 4242, 6.0, False, torch.device("cpu"),
                       time.perf_counter())
    checks = out["checks"]
    assert checks["compared_requests"]["value"] >= 1
    assert checks["cache_rule_miss"]["value"] == 0, checks
    assert checks["cache_fp_err"]["value"] < 0.05, checks
    assert checks["eps_cached_err"]["value"] < 0.15, checks
    assert checks["eps_full_err"]["value"] < 0.15, checks

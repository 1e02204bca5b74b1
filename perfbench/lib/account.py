"""The work the window's steps needed, from the probe's records and the
part tables of ``perfbench/work/``: each request's step by its mode and
the pairs recomputed for it, each decode and each text encoding finished
in the window.  Pad rows and pad patches are never counted; a reused pair
or deep feature needs no work."""

from __future__ import annotations

from typing import Dict

from perfbench.lib import spec
from perfbench.work import parts


def _decisions(rec: dict, j: int):
    mode = rec["mode"]
    fresh = mode == "full"
    if mode == "partial":
        fresh = j in rec["_sel"]
    gated = {}
    for key, hits in rec["_hits"].items():
        half = len(hits) // 2
        gated[key] = ((hits[j] == 0) + (hits[half + j] == 0)) / 2
    return mode or "full", fresh, gated


def window_work(cfg: dict, probe, w0: float, w1: float, boundary) -> Dict:
    """``{"flops", "attn_bound_s", "steps", "rows"}`` over the steps,
    decodes and prepares whose host span ends inside ``[w0, w1)``."""
    mods: Dict[str, object] = {}
    flops = bound = 0.0
    n_steps = n_rows = 0
    for rec in probe.steps:
        if not (w0 <= rec["t1"] < w1):
            continue
        rec["_hits"] = {k: v.tolist() for k, v in rec["hits"].items()}
        sel = rec.get("sel")
        rec["_sel"] = set(sel.tolist()) if sel is not None else set()
        n_steps += 1
        for j, res in enumerate(rec["res"]):
            mode, fresh, gated = _decisions(rec, j)
            if mode not in mods:
                mods[mode] = spec.work_module(mode)
            fl, calls = mods[mode].work(parts.unet(cfg, res, boundary),
                                        gated, fresh)
            flops += fl
            bound += sum(parts.attn_bound_s(f, b) for f, b in calls)
            n_rows += 1
    for t0, t1, rows in probe.decoded:
        if w0 <= t1 < w1:
            flops += sum(parts.decode(cfg, res) for res, _ in rows)
    for t0, t1, rows in probe.prepared:
        if w0 <= t1 < w1:
            flops += parts.text(cfg) * len(rows)
    return {"flops": flops, "attn_bound_s": bound, "steps": n_steps,
            "rows": n_rows}

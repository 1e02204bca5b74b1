"""Whether what the timed path produced is correct: the tracked requests
(a sample drawn from the seed, the largest size among them) replayed by
the plain float32 reference, once the window has closed and the program's
state is freed.

The reference makes its own weights from the seed (the same tensors the
program was handed), encodes each prompt itself and draws each request's
starting noise itself.  Each denoising step starts from the latents the
program held before it (a step is judged, not the drift of fifty).  The
step's deep-cache mode and which CFG pairs a gate recomputed are the
program's choices, which depend on the whole batch; the reference holds
each against rules it works out itself, and works out the cache's values
itself:

- the deep feature: a request has to compute it (a full step, or a
  partial step that selects it) in its first ``deep_warmup`` steps and
  once ``deep_interval`` steps have passed since it last did; on any
  other step it reuses the feature the reference computed at its last
  such step;
- a gated pair's rows: a row holds the newest value the reference
  computed for this request (under row warmup the program carries a
  request's rows into each new batch composition and drops the old
  entry), which the program's fingerprint of the rows before the gate has
  to show; after a recompute it has to show the reference's new value.
  A row of zeros (a fresh cache: a request new to the composition) has to
  be recomputed;
- the gate's choice: it recomputes ``max(1, round(bucket x
  pair_fraction))`` pairs, both CFG halves of a pair together, and by the
  reference's own drift score (the rows' relative drift from the input
  they were last computed from, both halves) a pair it left out may not
  lie above the least drifted pair it recomputed, nor one it recomputed
  below the most drifted it left out, by more than the tie margin.  The
  boundary is read from the program's scores of the whole batch; the
  program's forced rows (a row at ``max_hits``, or one carried into a new
  composition) are the program's to choose.

Numbers, each against its limit in ``perfbench/limits/<cell>.json``:

- ``text_err``: relative L2 error of the program's text conditioning;
- ``eps_full_err`` / ``eps_cached_err``: relative L2 error of the program's
  guided model output on steps that computed the deep feature / that
  reused it, the widest over the sample;
- ``euler_err``: the starting latents and each step's update from the
  program's own model output, largest error over the largest value;
- ``decode_err``: mean absolute difference, in 8-bit counts, of the
  returned image and the reference's decode of the program's final
  latents;
- ``cache_fp_err``: the widest distance between the fingerprint of a
  cached value the program held or wrote and the reference's own value;
- ``cache_rule_miss``: the steps at which the program broke one of the
  rules above (limit 0).

The control (``control=True``) puts the reference itself, computed in
float8 (e4m3), in the program's place: it makes the same kind of record
(following the program's modes and gate choices on its own trajectory)
and is judged by the same comparison.  Only the dense path is replayed
(the probe records no other), the only one a cell drives.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, List, Optional

import torch

from perfbench.lib import fingerprint
from perfbench.lib import weights as wts
from perfbench.reference import clip as rclip
from perfbench.reference import euler, models, ops

NUMBERS = ("text_err", "eps_full_err", "eps_cached_err", "euler_err",
           "decode_err", "cache_fp_err", "cache_rule_miss")
# a request whose widest model-output gap passes this prints every step
TRAIL_ERR = 0.15
FORCED = 5e5  # a program score above this is a forced row's


def _raise(nums: Dict[str, float], key: str, v: float) -> None:
    """Raise a reading to ``v``; a NaN reads as infinitely wrong."""
    if math.isnan(v):
        v = math.inf
    nums[key] = max(nums[key], v)


def _rel(a, b) -> float:
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


class Replay:
    """The reference models of one configuration on ``device``."""

    def __init__(self, cfg: dict, seed: int, device):
        ops.float32_numerics()
        self.cfg = cfg
        self.device = device
        tensors = wts.make(cfg, seed, device, getattr(torch, cfg["dtype"]))
        self.m = models.load(models.build(cfg), tensors, device)
        del tensors
        self.guidance = float(cfg["guidance_scale"])
        self.boundary = None

    # -- text ---------------------------------------------------------------

    def encode(self, prompts: List[str]) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        feats, pooled = [], None
        for name in models.TEXT_ENCODERS:
            if name not in cfg:
                continue
            ids = torch.from_numpy(rclip.tokenize(
                prompts, cfg[name]["vocab_size"])).to(self.device)
            f, p = self.m[name](ids, cfg[name]["output"] == "penultimate")
            feats.append(f)
            pooled = p
        return {"embeds": torch.cat(feats, dim=-1), "pooled": pooled}

    def conditioning(self, prompt: str, negative: str) -> dict:
        pos, neg = self.encode([prompt]), self.encode([negative])
        out = {"embeds": pos["embeds"], "neg_embeds": neg["embeds"]}
        if "text_encoder_2" in self.cfg:
            out["pooled"], out["neg_pooled"] = pos["pooled"], neg["pooled"]
        return out

    # -- one guided step -----------------------------------------------------

    def eps(self, x, t: float, sigma: float, cond: dict, res: int,
            deep, hook):
        lat = euler.scale_input(x, sigma)
        lat = torch.cat([lat, lat])
        tt = torch.full((2,), float(t), device=self.device)
        ehs = torch.cat([cond["neg_embeds"], cond["embeds"]])
        added = None
        if "pooled" in cond:
            ids = torch.tensor([[res, res, 0.0, 0.0, res, res]] * 2,
                               device=self.device)
            added = {"text_embeds": torch.cat([cond["neg_pooled"],
                                               cond["pooled"]]),
                     "time_ids": ids}
        out, feat = self.m["unet"](lat, tt, ehs, added, deep=deep,
                                   boundary=self.boundary, hook=hook)
        u, c = out.chunk(2)
        return u + self.guidance * (c - u), feat

    def decode(self, latents):
        return self.m["vae"].decode(latents)



class Rules:
    """What the cell's cache preset states, from its limits file's
    ``rules``: ``deep_interval``, ``deep_warmup``, ``pair_fraction``,
    ``mse_threshold`` and the gate's ``tie_margin``."""

    def __init__(self, rules: dict):
        self.interval = int(rules["deep_interval"])
        self.warmup = int(rules["deep_warmup"])
        self.fraction = float(rules["pair_fraction"])
        self.threshold = float(rules["mse_threshold"])
        self.tie = float(rules["tie_margin"])


class Held:
    """A value the reference computed for a pair's rows (both CFG halves,
    NCHW), the input it computed it from, and its fingerprint."""

    def __init__(self, y, inp):
        self.y, self.inp = y, inp
        self.fp = fingerprint.of(y)


class Store:
    """The reference's own cache state of one replayed request: its deep
    feature, the step that computed it, and each pair's newest rows."""

    def __init__(self):
        self.deep: Optional[Held] = None
        self.fresh_at = -1
        self.rows: Dict[str, Held] = {}


def _drift(x, inp) -> float:
    """A pair's drift score as the gate defines it, both halves summed:
    per row ``mean((x - inp)^2) / (mean(x^2) + 1e-8)``."""
    x, inp = x.float(), inp.float()
    d = (x - inp).square().mean(dim=(1, 2, 3))
    return float((d / (x.square().mean(dim=(1, 2, 3)) + 1e-8)).sum())


def _gate_rules(rules: Rules, rec: dict, key: str, j: int, redo: bool,
                d_ref: Optional[float], miss: list, gaps: list) -> None:
    """The gate's count and the tracked pair's rank (module docstring)."""
    hits = rec["hits"][key].cpu()
    bb = hits.shape[0] // 2
    sc = rec["scores"].get(key)
    if sc is None:
        miss.append(f"{key}: no drift scores recorded")
        return
    sc = sc.double().cpu()
    pair = sc[:bb] + sc[bb:]
    real = torch.isfinite(pair)
    sel = (hits[:bb] == 0) & (hits[bb:] == 0) & real
    cap = max(1, round(bb * rules.fraction))
    want = min(cap, int(real.sum()))
    if int(sel.sum()) != want:
        miss.append(f"{key}: recomputed {int(sel.sum())} pairs of "
                    f"{int(real.sum())}, the preset asks {want}")
    forced = pair > FORCED
    if forced[j] or d_ref is None:
        return
    drift = pair + 2 * rules.threshold
    d_prog = float(drift[j])
    if d_prog > 0 and d_ref > 0:
        gaps.append(abs(math.log(d_ref / d_prog)))
    chosen = drift[sel & ~forced]
    left = drift[real & ~sel & ~forced]
    m = 1.0 + rules.tie
    if not redo and len(chosen) and d_ref > float(chosen.min()) * m:
        miss.append(f"{key}: left out at drift {d_ref:.4g}, recomputed one "
                    f"at {float(chosen.min()):.4g}")
    if redo and len(left) and d_ref * m < float(left.max()):
        miss.append(f"{key}: recomputed at drift {d_ref:.4g}, left out one "
                    f"at {float(left.max()):.4g}")


def _mode(st: dict):
    """``(record, row, mode, fresh)`` of a step; a step with the cache
    off (mode None) computes everything, as a full one does."""
    rec, j = st["rec"], st["step_index"]
    mode = rec["mode"] or "full"
    if mode not in ("full", "shallow", "partial"):
        raise RuntimeError(f"a step in deep mode {mode!r}")
    fresh = mode == "full"
    if mode == "partial":
        fresh = j in set(rec["sel"].tolist())
    return rec, j, mode, fresh


def follow(rp: Replay, item, data: dict, nums: Dict[str, float],
           rules: Rules, check_rules: bool = True,
           worst: Optional[list] = None, gaps: Optional[list] = None) -> None:
    """Replay one tracked request's record ``data`` (the program's, or the
    control's made by :func:`control_data`) and raise ``nums`` to its
    readings; ``check_rules``: also hold the record's choices to the
    rules (the program's only)."""
    cfg = rp.cfg
    res = item.resolution
    hw = res // 8
    ts, sig, sigma0 = euler.schedule(cfg["scheduler"], item.steps)
    cond = rp.conditioning(item.prompt, "")
    for k, v in cond.items():
        _raise(nums, "text_err", _rel(data["cond"][k], v))
    x0_ref = euler.initial_latents(item.seed, hw, cfg["unet"]["in_channels"],
                                   sigma0).to(rp.device)
    x = data["x0"].float()
    _raise(nums, "euler_err", float(
        (x - x0_ref).abs().max() / x0_ref.abs().max()))
    store = Store()
    miss: List[str] = []
    gaps = [] if gaps is None else gaps
    trail = []
    for s, st in enumerate(data["steps"]):
        rec, j, mode, fresh = _mode(st)
        due = (s < rules.warmup or store.deep is None
               or s - store.fresh_at >= rules.interval)
        if check_rules and due and not fresh:
            miss.append(f"step {s}: the deep feature was due and reused")
        deep_in = None
        if not fresh and store.deep is not None:
            deep_in = store.deep.y
            fp = rec.get("fp", {}).get("deep", {}).get(j)
            if fp is None:
                miss.append(f"step {s}: no fingerprint of the deep feature")
            else:
                _raise(nums, "cache_fp_err",
                       fingerprint.distance(fp, store.deep.fp))
        step_miss: List[str] = []

        def hook(key, xx, fn):
            if mode == "full":
                store.rows[key] = Held(fn(xx), xx)
                return store.rows[key].y
            hits = rec["hits"].get(key)
            if hits is None:
                step_miss.append(f"{key}: no gate recorded")
                return fn(xx)
            bb = hits.shape[0] // 2
            halves = (bool(hits[j] == 0), bool(hits[bb + j] == 0))
            if check_rules and halves[0] != halves[1]:
                step_miss.append(f"{key}: CFG halves split")
            redo = halves[0] and halves[1]
            pre = rec["fp_pre"][key][j]
            held = None
            if fingerprint.is_zero(pre):
                if check_rules and not redo:
                    step_miss.append(f"{key}: a fresh row reused")
            elif key not in store.rows:
                step_miss.append(f"{key}: holds a value the reference "
                                 "never computed")
            else:
                held = store.rows[key]
                _raise(nums, "cache_fp_err",
                       fingerprint.distance(pre, held.fp))
            if check_rules:
                _gate_rules(rules, rec, key, j, redo,
                            None if held is None else _drift(xx, held.inp),
                            step_miss, gaps)
            if redo or held is None:
                h = store.rows[key] = Held(fn(xx), xx)
                if redo:
                    _raise(nums, "cache_fp_err", fingerprint.distance(
                        rec["fp"][key][j], h.fp))
                return h.y
            return held.y

        e, feat = rp.eps(x, ts[s], float(sig[s]), cond, res, deep_in, hook)
        if fresh:
            store.deep = Held(feat, feat)
            store.fresh_at = s
        miss += [f"step {s}: {m}" for m in step_miss]
        key = "eps_full_err" if fresh else "eps_cached_err"
        ep = st["eps"]
        err = _rel(ep, e)
        _raise(nums, key, err)
        where = f"{data.get('id', '')} step {s} {mode} fresh={fresh}"
        trail.append((err, f"{where} err={err:.4g}"))
        if worst is not None:
            worst.append((err, where))
        x_ref = euler.step(x, ep, float(sig[s]), float(sig[s + 1]))
        x_next = st["x_next"].float()
        _raise(nums, "euler_err", float(
            (x_next - x_ref).abs().max() / x_ref.abs().max()))
        x = x_next
    if check_rules and any(e > TRAIL_ERR for e, _ in trail):
        # the way to the widest gap, for the run's record
        for _, line in trail:
            print(f"perfbench: {line}", file=sys.stderr)
    for m in miss[:8]:
        print(f"perfbench: {data.get('id', '')} broke a cache rule: {m}",
              file=sys.stderr)
    nums["cache_rule_miss"] += len(miss)
    img = rp.decode(x)
    port_img = torch.as_tensor(data["image"]).to(rp.device).float()
    _raise(nums, "decode_err", float(
        (port_img - torch.round(img[0])).abs().mean()))


def control_data(rp: Replay, item, data: dict, rules: Rules) -> dict:
    """The record the float8 control makes in the program's place: its
    own text encoding, noise and trajectory (latents stored in float8),
    each step in the program's mode and with the program's gate choices,
    over values it computed itself (a reused row or deep feature: its
    newest)."""
    cfg = rp.cfg
    res = item.resolution
    ts, sig, sigma0 = euler.schedule(cfg["scheduler"], item.steps)
    with ops.fp8(True):
        cond = rp.conditioning(item.prompt, "")
    x = ops.quant(euler.initial_latents(
        item.seed, res // 8, cfg["unet"]["in_channels"], sigma0).to(
            rp.device))
    out = {"id": data.get("id", ""), "cond": cond, "x0": x, "steps": []}
    store = Store()
    for s, st in enumerate(data["steps"]):
        rec, j, mode, fresh = _mode(st)
        mine = {"mode": mode, "sel": rec["sel"],
                "ids": rec["ids"], "hits": rec["hits"], "scores": {},
                "fp": {}, "fp_pre": {}}
        deep_in = None
        if not fresh and store.deep is not None:
            deep_in = store.deep.y
            mine["fp"]["deep"] = {j: store.deep.fp}

        def hook(key, xx, fn):
            if mode == "full":
                store.rows[key] = Held(fn(xx), xx)
                return store.rows[key].y
            hits = rec["hits"][key]
            bb = hits.shape[0] // 2
            redo = bool(hits[j] == 0) and bool(hits[bb + j] == 0)
            held = store.rows.get(key)
            mine["fp_pre"][key] = {j: held.fp if held is not None
                                   else torch.zeros(1)}
            if redo or held is None:
                held = store.rows[key] = Held(fn(xx), xx)
            mine["fp"][key] = {j: held.fp}
            return held.y

        with ops.fp8(True):
            e, feat = rp.eps(x, ts[s], float(sig[s]), cond, res, deep_in,
                             hook)
        if deep_in is None:
            store.deep = Held(feat, feat)
        x_next = ops.quant(euler.step(x, e, float(sig[s]), float(sig[s + 1])))
        out["steps"].append({"step_index": j, "rec": mine, "x_next": x_next,
                             "eps": e})
        x = x_next
    with ops.fp8(True):
        out["image"] = torch.round(rp.decode(x)[0])
    return out


def judge(cfg: dict, limits: dict, served, seed: int, device, boundary,
          control: bool = False) -> dict:
    """The numbers of the sample (``"numbers"``), with the widest gap of
    the reference's drift score from the program's (``"drift_gap"``);
    with ``control`` also the float8 control's numbers (``"control"``)."""
    data = served.probe.tracked_data
    ok = [rid for rid in served.tracked
          if rid in data and any(r.request_id == rid and r.ok
                                 for r in served.records)]
    rules = Rules(limits["rules"])
    rp = Replay(cfg, seed, device)
    rp.boundary = boundary
    nums = {k: 0.0 for k in NUMBERS}
    ctrl = {k: 0.0 for k in NUMBERS}
    worst, gaps = [], []
    with torch.inference_mode():
        for rid in ok:
            item = served.items[rid]
            data[rid]["id"] = rid
            follow(rp, item, data[rid], nums, rules, worst=worst, gaps=gaps)
            if control:
                follow(rp, item, control_data(rp, item, data[rid], rules),
                       ctrl, rules, check_rules=False)
    out = {"numbers": nums, "compared": len(ok),
           "worst": sorted(worst, reverse=True)[:5],
           "drift_gap": max(gaps, default=0.0)}
    if control:
        out["control"] = ctrl
    return out

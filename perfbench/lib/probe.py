"""Wrappers around the pipeline's stage and step entries (the pattern of
``chip_smoke.py``'s spies), installed on one pipeline object.

They record, with no read back to the host while the window runs:

- host spans of every prepare, dense denoise step and decode group (for
  the traced run's idle gaps and for counting the window's work; the
  patch path's steps, which no cell drives, are not recorded);
- each denoise step's requests, deep mode, the partial step's rows and,
  after each gated pair, its row caches' hit counters (a row at 0 was
  recomputed) and the drift scores it ranked, from which the work each
  request's step needed follows and against which the check holds its
  own decisions;
- for the tracked requests (the correctness sample): the conditioning, the
  starting latents, each step's guided model output and new latents, the
  fingerprints (``lib/fingerprint.py``) of the rows each gated pair held
  before its gate and after it and of the deep feature a step was given,
  and the decoded image.

Device tensors are kept by reference (or cloned where the program would
overwrite them) and read after the window closes.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import torch

from perfbench.lib import fingerprint
from sduss_tpu_torch.cache.manager import BlockCache


def now() -> float:
    return time.perf_counter()


class Probe:
    def __init__(self, pipe, trace: bool):
        self.pipe = pipe
        self.trace = trace
        self.tracked: set = set()
        self.spans: List[tuple] = []          # (kind, t0, t1, n_requests)
        self.steps: List[dict] = []
        self.tracked_data: Dict[str, dict] = {}
        self.decoded: List[tuple] = []        # (t0, t1, [(res, id)])
        self.prepared: List[tuple] = []       # (t0, t1, [res])
        self._tls = threading.local()
        self._install()

    # -- context of the step running on this thread ------------------------

    @property
    def cur(self) -> Optional[dict]:
        return getattr(self._tls, "cur", None)

    def _install(self) -> None:
        pipe = self.pipe
        self._orig = {}
        for name, wrapper in (("prepare", self._wprepare),
                              ("_denoise_group", self._wdenoise_group),
                              ("_deep_step", self._wdeep_step),
                              ("_decode_group", self._wdecode_group)):
            self._orig[name] = getattr(pipe, name)
            setattr(pipe, name, wrapper)
        sampler = pipe.sampler
        self._orig_step = sampler.step
        sampler.step = self._wstep
        probe = self

        def wrap_gate(fn):
            def gate(cache, key, x, t_norm, state_k, *a, **kw):
                cur = probe.cur
                need = cur is not None and cur["need"]
                if need:
                    probe._fingerprint(cur, "fp_pre", key, state_k["out"])
                out = fn(cache, key, x, t_norm, state_k, *a, **kw)
                if need:
                    cur["hits"][key] = out[1]["hits"].clone()
                    if "scores" in out[2]:
                        cur["scores"][key] = out[2]["scores"].clone()
                    probe._fingerprint(cur, "fp", key, out[1]["out"])
                return out
            gate.__wrapped__ = fn
            return gate

        self._gates = {}
        for name in ("gate_compact_pairs", "gate_compact_images"):
            fn = getattr(BlockCache, name)
            self._gates[name] = fn
            setattr(BlockCache, name, wrap_gate(fn))

    def remove(self) -> None:
        for name, fn in self._orig.items():
            setattr(self.pipe, name, fn)
        self.pipe.sampler.step = self._orig_step
        for name, fn in self._gates.items():
            setattr(BlockCache, name, fn)
        # the originals are bound to the pipeline: drop them with it
        self._orig, self._orig_step, self._gates = {}, None, {}

    def _fingerprint(self, cur: dict, kind: str, key: str, out) -> None:
        """For each tracked request of the step: the fingerprints ``(2, K,
        C)`` of its uncond and cond rows of ``out`` (NCHW, CFG halves ``[u
        x bb | c x bb]``): a gated pair's cached output before the gate
        (``kind`` ``"fp_pre"``) or after it (``"fp"``), or, under
        ``"deep"``, the deep feature a step is given."""
        half = out.shape[0] // 2
        for j, rid in enumerate(cur["ids"]):
            if rid not in self.tracked:
                continue
            fp = fingerprint.of(torch.stack([out[j], out[half + j]]))
            cur.setdefault(kind, {}).setdefault(key, {})[j] = fp

    # -- stages -------------------------------------------------------------

    def _wprepare(self, requests):
        t0 = now()
        out = self._orig["prepare"](requests)
        t1 = now()
        self.spans.append(("prepare", t0, t1, len(requests)))
        self.prepared.append((t0, t1, [r.resolution for r in requests]))
        for r in requests:
            if r.request_id in self.tracked:
                self.tracked_data[r.request_id] = {
                    "cond": dict(r.conditioning), "x0": r.latents,
                    "steps": [], "image": None}
        return out

    def _wdecode_group(self, reqs):
        t0 = now()
        out = self._orig["_decode_group"](reqs)
        t1 = now()
        self.spans.append(("decode", t0, t1, len(reqs)))
        self.decoded.append((t0, t1, [(r.resolution, r.request_id)
                                      for r in reqs]))
        for r in reqs:
            d = self.tracked_data.get(r.request_id)
            if d is not None:
                d["image"] = r.output
        return out

    def _begin(self, reqs) -> dict:
        cur = {"ids": [r.request_id for r in reqs],
               "res": [r.resolution for r in reqs], "mode": None,
               "sel": None, "hits": {}, "scores": {}, "t0": now(),
               "need": self.trace or any(r.request_id in self.tracked
                                         for r in reqs)}
        self._tls.cur = cur
        return cur

    def _end(self, cur: dict, reqs) -> None:
        cur["t1"] = now()
        self._tls.cur = None
        self.spans.append(("denoise", cur["t0"], cur["t1"], len(reqs)))
        self.steps.append(cur)
        for j, r in enumerate(reqs):
            d = self.tracked_data.get(r.request_id)
            if d is None:
                continue
            d["steps"].append({"step_index": j, "rec": cur,
                               "x_next": r.latents,
                               "eps": cur["eps_rows"][j]
                               if cur.get("eps_rows") else None})

    def _wdenoise_group(self, reqs):
        cur = self._begin(reqs)
        try:
            return self._orig["_denoise_group"](reqs)
        finally:
            self._end(cur, reqs)

    def _wdeep_step(self, mode, row_valid, latents, t, coeffs, guidance,
                    cond, deep, state, sel):
        cur = self.cur
        if cur is not None:
            cur["mode"], cur["sel"] = mode, sel
            if deep is not None and cur["need"]:
                self._fingerprint(cur, "fp", "deep", deep)
        return self._orig["_deep_step"](mode, row_valid, latents, t, coeffs,
                                        guidance, cond, deep, state, sel)

    def _wstep(self, x, model_out, c0, c1, *a, **kw):
        cur = self.cur
        if cur is not None:
            tracked = [j for j, rid in enumerate(cur["ids"])
                       if rid in self.tracked]
            if tracked:
                cur["eps_rows"] = {j: model_out[j:j + 1].clone()
                                   for j in tracked}
        return self._orig_step(x, model_out, c0, c1, *a, **kw)

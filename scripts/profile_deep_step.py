#!/usr/bin/env python3
"""Where the time of a deep-cache step goes in the PyTorch/CUDA port.

    python3 scripts/profile_deep_step.py [--steps 3] [--mixed | --sd3] [--out FILE]

Needs one CUDA card.  Builds the full-width SDXL and SD-1.5 pipelines of
``sduss_tpu_torch`` (random bf16 weights from seed 0, TF32 off, dense
path, or with ``--mixed`` the mixed patch path) and profiles, with
``scripts/profile_torch_step.py``'s ``profile`` (wall ms by CUDA events,
device-busy ms, device ms by op class):

  1. SDXL 8 x 1024^2 (16 denoiser rows) under
     ``CacheConfig.production("sdxl", serving=False)``, the bench's
     default trajectory: ``--steps`` shallow steps, and ``--steps`` full
     steps (each forced by an expired age, as the refresh policy forces
     one);
  2. SD-1.5 3 x 512^2 (bucket 4, 8 rows) under
     ``production("sd15", serving=True)``: shallow, full and partial steps
     (one request's deep feature dropped, as an admission has none).

With ``--mixed``, one mixed batch a step (``denoise_step_mixed``):

  1. SDXL 768^2 + 3 x 1024^2 (CFG: 128 patch rows of 32^2 latent cells)
     under ``production("sdxl", serving=False)``: shallow steps (the image
     gate recomputes one 1024^2 pair of three and the 768^2 pair on the
     50-patch sub-composition) and full steps;
  2. SD-1.5 4 x 512^2 + 768^2 (CFG: 64 patch rows) under
     ``production("sd15", serving=True)``: shallow (one 512^2 pair of four
     and the 768^2 pair recomputed) and full steps.

With ``--sd3``, SD-3.5-medium's caches on its token path:

  1. 4 x 1024^2 (CFG: 8 rows of 4096 latent + 333 text tokens) under
     ``production("sd3", serving=False)`` (span 1:24): shallow steps (block
     0, the embedding, the head and the sampler) and full steps (each
     forced by an expired delta), and their ratio;
  2. 2 x 1024^2 under each token cache mode (block; compact 0.5; fine 0.5,
     with and without stale K/V): the steady step, after the first one
     anchored the composition's rows.

Each profiled mode is checked against the mode the pipeline ran.  The last
line is a JSON object with every number; ``--out`` also writes it to a
file.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from profile_torch_step import (card_line, prepared, print_profile,  # noqa: E402
                                profile)
from sduss_tpu_torch import configure_numerics  # noqa: E402
from sduss_tpu_torch.config import CacheConfig  # noqa: E402
from sduss_tpu_torch.entrypoints.offline import default_config  # noqa: E402
from sduss_tpu_torch.pipelines import build_pipeline  # noqa: E402
from sduss_tpu_torch.pipelines.base import _state_nbytes  # noqa: E402

CELLS = {"sdxl": (1024, 8, False), "sd15": (512, 3, True)}  # res, batch, serving
# the mixed path: {resolution: requests}, serving preset
MIXED = {"sdxl": ({768: 1, 1024: 3}, False), "sd15": ({512: 4, 768: 1}, True)}


def deep_pipeline(family: str, serving: bool, mixed: bool = False):
    config = default_config(family, dtype="bfloat16", seed=0)
    config.scheduler.use_mixed_resolution = mixed
    config.cache = CacheConfig.production(family, serving=serving)
    pipe = build_pipeline(config, torch.device("cuda"))
    name = "_deep_step_mixed" if mixed else "_deep_step"
    modes, step = [], getattr(pipe, name)

    def spy(mode, *args):
        modes.append(mode)
        return step(mode, *args)

    setattr(pipe, name, spy)
    return pipe, modes


def profile_modes(family: str, steps: int, card: str) -> dict:
    res, batch, serving = CELLS[family]
    pipe, modes = deep_pipeline(family, serving)
    reqs = prepared(pipe, batch, res, tag=family)
    for _ in range(pipe.config.cache.deep_warmup + 1):  # past the warmup
        pipe.denoise_step({res: reqs})

    def shallow():
        pipe.denoise_step({res: reqs})

    def full():
        for r in reqs:
            r.deep_age = 10 ** 6  # the interval expired
        pipe.denoise_step({res: reqs})

    def partial():
        reqs[0].deep_state = None  # an admission: no deep feature yet
        pipe.denoise_step({res: reqs})

    out = {}
    runs = [("shallow", shallow), ("full", full)]
    if serving:
        runs.append(("partial", partial))
    for mode, fn in runs:
        del modes[:]
        prof = profile(fn, steps)
        if set(modes) != {mode}:
            raise AssertionError(f"{family} {mode} profile ran {modes}")
        print(f"{family} {batch} x {res}^2 {mode} step: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} "
              f"ms ({prof['busy_ms'] / prof['wall_ms']:.1%}) [{card}]")
        print_profile(prof)
        out[mode] = prof
    out["state_bytes"] = sum(_state_nbytes(e["state"])
                             for e in pipe._comp_state.values())
    print(f"{family} hybrid row caches {out['state_bytes'] / 1e9:.3f} GB "
          f"[{card}]")
    return out


def profile_mixed(family: str, steps: int, card: str) -> dict:
    counts, serving = MIXED[family]
    pipe, modes = deep_pipeline(family, serving, mixed=True)
    by_res = {res: prepared(pipe, n, res, tag=f"{family}{res}_")
              for res, n in counts.items()}
    label = " + ".join(f"{n} x {res}^2" for res, n in counts.items())
    for _ in range(pipe.config.cache.deep_warmup + 1):  # past the warmup
        pipe.denoise_step_mixed(by_res)

    def shallow():
        pipe.denoise_step_mixed(by_res)

    def full():
        for reqs in by_res.values():
            for r in reqs:
                r.deep_age = 10 ** 6  # the interval expired
        pipe.denoise_step_mixed(by_res)

    out = {}
    for mode, fn in (("shallow", shallow), ("full", full)):
        del modes[:]
        prof = profile(fn, steps)
        if set(modes) != {mode}:
            raise AssertionError(f"{family} mixed {mode} profile ran {modes}")
        print(f"{family} mixed {label} {mode} step: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} "
              f"ms ({prof['busy_ms'] / prof['wall_ms']:.1%}) [{card}]")
        print_profile(prof)
        out[mode] = prof
    out["state_bytes"] = sum(_state_nbytes(e["state"])
                             for e in pipe._comp_state.values())
    print(f"{family} mixed hybrid row caches {out['state_bytes'] / 1e9:.3f} "
          f"GB [{card}]")
    return out


SD3_TOKEN_MODES = {
    "block": dict(mode="block", max_hits=2),
    "compact": dict(mode="compact", compact_fraction=0.5, max_hits=2),
    "fine": dict(mode="compact", patch_fraction=0.5, max_hits=2),
    "fine_stale_kv": dict(mode="compact", patch_fraction=0.5, max_hits=2,
                          fine_stale_kv=True),
}


def sd3_pipeline(cache: CacheConfig, bundle=None):
    """The SD3 pipeline under ``cache`` and the list its trunk calls fill
    with their mode: the deep mode, or "sync"/"stale"/"gated"."""
    config = default_config("sd3", dtype="bfloat16", seed=0)
    config.cache = cache
    pipe = build_pipeline(config, torch.device("cuda"), bundle=bundle)
    modes, trunk = [], pipe._trunk_fn

    def spy(*args, **kw):
        modes.append(kw.get("deep_mode") or (
            "sync" if kw.get("compact_sync") else
            "stale" if kw.get("fine_kv_stale") else "gated"))
        return trunk(*args, **kw)

    pipe._trunk_fn = spy
    return pipe, modes


def profile_sd3(steps: int, card: str) -> dict:
    pipe, modes = sd3_pipeline(CacheConfig.production("sd3", serving=False))
    reqs = prepared(pipe, 4, 1024, tag="sd3span")
    for _ in range(pipe.config.cache.deep_warmup + 1):  # past the warmup
        pipe.denoise_step({1024: reqs})

    def shallow():
        pipe.denoise_step({1024: reqs})

    def full():
        for entry in pipe._sd3_state.values():
            entry["deep_age"] = 10 ** 6  # the interval expired
        pipe.denoise_step({1024: reqs})

    out = {}
    for mode, fn in (("shallow", shallow), ("full", full)):
        del modes[:]
        prof = profile(fn, steps)
        if set(modes) != {mode}:
            raise AssertionError(f"sd3 span {mode} profile ran {modes}")
        print(f"sd3 4 x 1024^2 span 1:24 {mode} step: wall "
              f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} "
              f"ms ({prof['busy_ms'] / prof['wall_ms']:.1%}) [{card}]")
        print_profile(prof)
        out[f"span_{mode}"] = prof
    out["span_shallow_full_ratio"] = (out["span_shallow"]["wall_ms"]
                                      / out["span_full"]["wall_ms"])
    out["span_delta_bytes"] = pipe._live_state_bytes()
    print(f"sd3 span shallow/full wall ratio "
          f"{out['span_shallow_full_ratio']:.4f}; delta "
          f"{out['span_delta_bytes'] / 1e6:.1f} MB [{card}]")
    bundle = pipe.bundle
    del pipe, reqs
    for name, kw in SD3_TOKEN_MODES.items():
        torch.cuda.empty_cache()
        pipe, modes = sd3_pipeline(CacheConfig(enabled=True, **kw), bundle)
        reqs = prepared(pipe, 2, 1024, tag=f"sd3{name}")
        for _ in range(2):  # anchor (sync) the composition's rows
            pipe.denoise_step({1024: reqs})
        want = "stale" if kw.get("fine_stale_kv") else "gated"
        del modes[:]
        prof = profile(lambda: pipe.denoise_step({1024: reqs}), steps)
        if set(modes) != {want}:
            raise AssertionError(f"sd3 {name} profile ran {modes}")
        prof["state_bytes"] = pipe._live_state_bytes()
        print(f"sd3 2 x 1024^2 {name} step: wall {prof['wall_ms']:.2f} ms, "
              f"device busy {prof['busy_ms']:.2f} ms "
              f"({prof['busy_ms'] / prof['wall_ms']:.1%}), rows "
              f"{prof['state_bytes'] / 1e9:.3f} GB [{card}]")
        print_profile(prof)
        out[name] = prof
        del pipe, reqs
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=3,
                    help="timed steps per measurement")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--mixed", action="store_true",
                      help="profile the mixed patch path's deep steps")
    mode.add_argument("--sd3", action="store_true",
                      help="profile SD-3.5-medium's span and token caches")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_deep_step: no CUDA device")
    configure_numerics()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    result = {"card": card, "path": "sd3" if args.sd3 else
              "mixed" if args.mixed else "dense"}
    if args.sd3:
        result["sd3"] = profile_sd3(args.steps, card)
    run = profile_mixed if args.mixed else profile_modes
    for family in () if args.sd3 else CELLS:
        t0 = time.perf_counter()
        result[family] = run(family, args.steps, card)
        print(f"{family} done in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()

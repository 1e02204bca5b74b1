#!/usr/bin/env python3
"""A replica over an sp x tp group of distinct cards (one host, four
NVIDIA GPUs).

    python3 scripts/check_sp_cards.py

Raises with fewer than 4 cards.  From the repository root, with
chip_smoke.py's phases (random bf16 weights from seed 0): the kernels
built, then SDXL's dense 2 x 1024^2 pair, 8 Euler steps, cache off, on one
card and on a group of each layout below, each shard on its own card:

  sp=2 on [0, 1], tp=2 on [0, 1], sp=2 x tp=2 on [0, 1, 2, 3], sp=4 on
  [0, 1, 2, 3]

each held against the one-card run (``chip_smoke.check_group_run``:
latents within 2^-7 of max |one card|, every kernel launched sp * tp
times as often: each shard's forward launches one device's kernels), with
the step ms of each (CUDA events on the engine's stream, which waits for
every shard); then tp=2 on [0, 1] over a mixed 768^2 + 1024^2 + 768^2
batch whose composition changes twice as its requests finish (3, 8 and 5
steps; the second card rebuilds each step's patch context), held the same
way against one card; then what sp serves beyond the dense cache-off step:
the 768^2 + 1024^2 patch batch cache-off and under production("sdxl"), and
the dense pair under production("sdxl"), 8 steps each, at sp=2 on [0, 1]
and sp=4 on [0, 1, 2, 3] (``chip_smoke.check_paths_run``: within 2^-7 of
one card, the same deep modes, the share of gate decisions equal to one
card's, each shard's launches and state bytes, no kernel's plain version
run); then SD3.5-medium's dense 2 x 1024^2 pair, 4 steps, under
the same layouts (sp gathers the latent K/V: within 2^-7; with tp, within
chip_smoke's MOVED_MAX_REL; the attention launches sp * tp times one
card's).  Prints the card's name and power limit, each layout's
numbers and, last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from sduss_tpu_torch import configure_numerics  # noqa: E402
from sduss_tpu_torch.config import CacheConfig  # noqa: E402
from sduss_tpu_torch.ops import _build  # noqa: E402

# the mixed batch under tp=2: resolutions and each request's steps
MIXED = ([768, 1024, 768], [3, 8, 5])
# the patch batch and the production preset over sp: (label, sp, cards)
SP_LAYOUTS = [("sp=2", 2, [0, 1]), ("sp=4", 4, [0, 1, 2, 3])]
LAYOUTS = [  # (label, sp, tp, card indices)
    ("sp=2", 2, 1, [0, 1]),
    ("tp=2", 1, 2, [0, 1]),
    ("sp=2 x tp=2", 2, 2, [0, 1, 2, 3]),
    ("sp=4", 4, 1, [0, 1, 2, 3]),
]


def main() -> None:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 4:
        raise SystemExit(f"check_sp_cards: needs 4 CUDA devices, found {n}")
    t0 = time.perf_counter()
    configure_numerics()
    card = smoke.card_line()
    print(f"card: {card}; {n} cards: "
          f"{[torch.cuda.get_device_name(i) for i in range(n)]}")
    built = _build.build()
    _build.load_library()
    print(f"kernels built in {built.seconds:.1f} s")
    bundle = smoke.build_bundle()
    one = smoke.serve_group(bundle, "sdxl", smoke.GROUP_DENSE,
                            smoke.GROUP_STEPS, "cards")
    steps = {"one card": one["ms"]}
    for label, sp, tp, devices in LAYOUTS:
        got = smoke.serve_group(bundle, "sdxl", smoke.GROUP_DENSE,
                                smoke.GROUP_STEPS, "cards", sp=sp, tp=tp,
                                devices=devices)
        smoke.check_group_run(
            f"check_sp_cards SDXL {smoke.GROUP_DENSE} x {smoke.GROUP_STEPS} "
            f"steps, {label} on cards {devices}", got, one,
            smoke.GROUP_MAX_REL, card, launch_ratio=sp * tp)
        steps[label] = got["ms"]
    print(f"step ms (SDXL 2 x 1024^2, CFG, cache off): {steps} [{card}]")
    res, counts = MIXED
    one = smoke.serve_group(bundle, "sdxl", res, counts, "cards-mixed",
                            mixed=True)
    got = smoke.serve_group(bundle, "sdxl", res, counts, "cards-mixed",
                            tp=2, mixed=True, devices=[0, 1])
    smoke.check_group_run(
        f"check_sp_cards SDXL mixed {res} x {counts} steps, tp=2 on cards "
        f"[0, 1]", got, one, smoke.GROUP_MAX_REL, card, launch_ratio=2)
    if got["counts"]["k4"] == 0:
        raise AssertionError("check_sp_cards: the mixed batch ran no K4")
    for path, cache_label, res in (
            ("mixed", "cache-off", smoke.GROUP_MIXED),
            ("mixed", "production", smoke.GROUP_MIXED),
            ("dense", "production", smoke.GROUP_DENSE)):
        cache = (CacheConfig.production("sdxl")
                 if cache_label == "production" else None)
        kw = dict(mixed=path == "mixed", cache=cache,
                  record=cache is not None)
        one = smoke.serve_group(bundle, "sdxl", res, smoke.GROUP_STEPS,
                                f"cards-{path}-{cache_label}", **kw)
        steps = {"one card": one["ms"]}
        for label, sp, devices in SP_LAYOUTS:
            got = smoke.serve_group(bundle, "sdxl", res, smoke.GROUP_STEPS,
                                    f"cards-{path}-{cache_label}", sp=sp,
                                    devices=devices, **kw)
            # each shard launches one card's count at sp=2; at sp=4 a
            # shard may hold no query patch of a class, and its masked
            # attention (or K1 on the dense pair) launches fewer times
            attn = "masked" if path == "mixed" else "k1"
            rule = {attn: "equal" if sp == 2 else "some", "k5": "equal"}
            if path == "mixed":
                rule["k4"] = "equal"
            smoke.check_paths_run(
                f"check_sp_cards SDXL {path} {res} x {smoke.GROUP_STEPS} "
                f"steps, {cache_label}, {label} on cards {devices}", got, one,
                card, "SDXL 768^2 + 1024^2" if cache is None
                else f"production {path}", rule)
            steps[label] = got["ms"]
        print(f"step ms (SDXL {path} {res}, {cache_label}): {steps} "
              f"[{card}]")
    del bundle
    gc.collect()
    torch.cuda.empty_cache()
    # SD3.5-medium, whose forward issues fewer, longer kernels: the same
    # layouts against one card (gather is exact; tp's trajectory moves as
    # any change of summation order moves SD3's, chip_smoke's bound)
    sd3 = smoke.build_sd3_bundle()
    one = smoke.serve_group(sd3, "sd3", smoke.GROUP_DENSE,
                            smoke.SD3_GROUP_STEPS, "cards3")
    attn = sum(one["counts"].values())
    steps = {"one card": one["ms"]}
    for label, sp, tp, devices in LAYOUTS:
        got = smoke.serve_group(sd3, "sd3", smoke.GROUP_DENSE,
                                smoke.SD3_GROUP_STEPS, "cards3", sp=sp,
                                tp=tp, devices=devices)
        smoke.check_group_run(
            f"check_sp_cards SD3.5-medium {smoke.GROUP_DENSE} x "
            f"{smoke.SD3_GROUP_STEPS} steps, {label} on cards {devices}",
            got, one, smoke.GROUP_MAX_REL if tp == 1
            else smoke.MOVED_MAX_REL, card)
        n = sum(got["counts"].values())
        if n != sp * tp * attn:
            raise AssertionError(f"{label}: {n} attention launches, one "
                                 f"card {attn}")
        steps[label] = got["ms"]
    print(f"step ms (SD3.5-medium 2 x 1024^2, CFG, cache off): {steps} "
          f"[{card}]")
    print(f"check_sp_cards ran {time.perf_counter() - t0:.1f} s [{card}]")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

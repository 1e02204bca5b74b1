"""One device's SDXL step on the mixed patch path, timed through the
``chip_smoke.serve_group`` of a checkout of the port, so that two trees
(a change and its parent, unpacked beside it) compare on one card in one
call:

    python3 scripts/time_one_device_mixed.py [--root DIR] [--repeat N]
        [--record]

The 768^2 + 1024^2 batch (CFG, 8 Euler steps, random bf16 weights from
seed 0) runs cache-off and under ``CacheConfig.production("sdxl")``,
the pair ``--repeat`` times, each run on an Engine of its own; each step
is timed with CUDA events on the engine's stream and the mean after the
first is kept, as chip_smoke's group phases do.  ``--record`` also runs
the production preset with every gate's selections recorded
(chip_smoke's ``record=True``, in trees whose ``serve_group`` has it).
Prints the card's line and one JSON object.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))),
        help="the checkout whose chip_smoke.py and sduss_tpu_torch run")
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs of each configuration, in turn")
    ap.add_argument("--record", action="store_true",
                    help="also time the production preset with the gate "
                         "selections recorded")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("time_one_device_mixed: no CUDA card")
    import chip_smoke as smoke
    from sduss_tpu_torch import configure_numerics
    from sduss_tpu_torch.config import CacheConfig
    from sduss_tpu_torch.ops import _build

    configure_numerics()
    _build.build()
    _build.load_library()
    card = smoke.card_line()
    print(f"card: {card}")
    bundle = smoke.build_bundle("sdxl")
    out = {"root": root, "card": card}
    runs = [("cache-off", None, False),
            ("production", CacheConfig.production("sdxl"), False)]
    if args.record:
        runs.append(("production, picks recorded",
                     CacheConfig.production("sdxl"), True))
    for i in range(args.repeat):
        for label, cache, record in runs:
            kw = {"record": True} if record else {}
            got = smoke.serve_group(bundle, "sdxl", smoke.GROUP_MIXED,
                                    smoke.GROUP_STEPS, f"one-{i}-{label}",
                                    mixed=True, cache=cache, **kw)
            run = out.setdefault(label, {"step_ms": [],
                                         "modes": got["modes"]})
            run["step_ms"].append(got["ms"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()

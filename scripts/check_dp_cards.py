#!/usr/bin/env python3
"""dp replicas on distinct cards (one host, two or four NVIDIA GPUs).

    python3 scripts/check_dp_cards.py

Raises with fewer than 2 cards; the dp=4 runs need 4.  From the repository
root, with chip_smoke.py's phases (random bf16 weights from seed 0):

1. build the kernels (``tests/test_torch_cuda.py -k second`` holds each
   kernel on ``cuda:1`` tensors, while ``cuda:0`` is current, against
   its plain version);
2. SD-1.5, ``chip_smoke.serve_dp``: dp=2 on cards [0, 1], the same with
   ``steps_per_dispatch`` 4 (step graphs captured and replayed on each
   replica's card) and dp=4 on [0, 1, 2, 3]: the greedy dispatch against
   its host recomputation, every replica used, and each replica's latents
   bitwise equal to a dp=1 engine on that replica's card serving that
   replica's requests (the replicas off card 0 serve a copy of the
   weights, ``ModelBundle.replicate``);
3. SDXL, ``chip_smoke.replay_sdxl`` at dp=4 on [0, 1, 2, 3] (buckets 1, 2,
   4 prewarmed on every replica): the SLO metrics, the requests per
   replica and each card's busy share over the replay (torch.profiler,
   CUDA activity; its host cost a launch lowers the share it reads).

Prints the card's name and power limit, each phase's numbers and, last,
``{"ok": true, "device": {...}}``.
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
from sduss_tpu_torch.ops import _build  # noqa: E402

DP_RES = [512] * 8
REPLAY_BUCKETS = (1, 2, 4)


def main() -> None:
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        raise SystemExit(f"check_dp_cards: needs 2 CUDA devices, found {n}")
    t0 = time.perf_counter()
    configure_numerics()
    card = smoke.card_line()
    print(f"card: {card}; {n} cards: "
          f"{[torch.cuda.get_device_name(i) for i in range(n)]}")
    built = _build.build()
    _build.load_library()
    print(f"kernels built in {built.seconds:.1f} s")

    sd15 = smoke.build_bundle("sd15")
    smoke.serve_dp(card, sd15, [0, 1], DP_RES[:4])
    smoke.serve_dp(card, sd15, [0, 1], DP_RES[:4], spd=4)
    if n >= 4:
        smoke.serve_dp(card, sd15, [0, 1, 2, 3], DP_RES)
    del sd15
    gc.collect()
    torch.cuda.empty_cache()

    sdxl = smoke.build_bundle("sdxl")
    smoke.replay_sdxl(card, sdxl, devices=list(range(min(n, 4))),
                      buckets=REPLAY_BUCKETS, busy=True)
    print(f"check_dp_cards ran {time.perf_counter() - t0:.1f} s [{card}]")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n}}))


if __name__ == "__main__":
    main()

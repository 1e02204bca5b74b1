#!/usr/bin/env python3
"""Where a sharded SDXL forward's time goes on one card (NVIDIA GPU).

    python3 scripts/profile_group_step.py [--out FILE.json]

From the repository root, with chip_smoke.py's SDXL bundle (random bf16
weights from seed 0): one CFG forward of the UNet at 2 x 1024^2 (4 rows)
on one device, then on groups of two shards on card 0 (tp=2, sp=2 with a
``ShardContext`` a shard), each after two warm-up forwards:

- the host's enqueue ms a forward (the call returns before the card is
  done) and the wall ms once the card has finished, over 5 forwards;
- the device's kernel ms summed over its streams (torch.profiler, one
  forward);
- the group's collectives a forward and each shard's ms inside them
  (depositing, waiting for its turn, reading its peers).

Prints the card's name and power limit beside every number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as smoke  # noqa: E402
from sduss_tpu_torch import configure_numerics  # noqa: E402
from sduss_tpu_torch.ops import _build  # noqa: E402
from sduss_tpu_torch.parallel.displaced import (ShardContext,  # noqa: E402
                                                shard_rows)
from sduss_tpu_torch.parallel.group import ShardGroup  # noqa: E402
from sduss_tpu_torch.parallel.sharding import ShardedDenoiser  # noqa: E402

FORWARDS = 5


def timed_exchange(stats: dict):
    """Wrap ``ShardGroup._exchange`` to count each shard's collectives and
    the seconds it spends in them."""
    real = ShardGroup._exchange

    def exchange(self, xs):
        r = self.rank()
        t0 = time.perf_counter()
        out = real(self, xs)
        stats["s"][r] += time.perf_counter() - t0
        stats["n"][r] += 1
        return out

    ShardGroup._exchange = exchange
    return real


def measure(fn, card: str, label: str, stats=None) -> dict:
    with torch.inference_mode():
        if stats is not None:
            stats["s"], stats["n"] = [0.0] * 2, [0] * 2
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        if stats is not None:  # count the timed forwards alone
            stats["s"], stats["n"] = [0.0] * 2, [0] * 2
        t0 = time.perf_counter()
        for _ in range(FORWARDS):
            fn()
        host = (time.perf_counter() - t0) / FORWARDS * 1e3
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / FORWARDS * 1e3
        out = {"host_ms": host, "wall_ms": wall}
        if stats is not None:
            out["collectives"] = [n // FORWARDS for n in stats["n"]]
            out["in_collectives_ms"] = [s / FORWARDS * 1e3
                                        for s in stats["s"]]
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    device = sum(e.self_device_time_total
                 for e in prof.key_averages()) / 1e3
    out["device_ms"] = device
    print(f"{label}: host enqueue {host:.1f} ms, wall {wall:.1f} ms, "
          f"device kernels {device:.1f} ms"
          + (f", collectives a forward {out['collectives']}, a shard's ms "
             f"in them {[round(s, 1) for s in out['in_collectives_ms']]}"
             if stats is not None else "") + f" [{card}]", flush=True)
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_group_step: no CUDA device")
    configure_numerics()
    card = smoke.card_line()
    _build.build()
    _build.load_library()
    unet = smoke.build_bundle().models["unet"]
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(4, 128, 128, 4, generator=gen,
                    device="cuda").to(torch.bfloat16)
    ehs = torch.randn(4, 77, 2048, generator=gen,
                      device="cuda").to(torch.bfloat16)
    added = {"text_embeds": torch.randn(4, 1280, generator=gen,
                                        device="cuda").to(torch.bfloat16),
             "time_ids": torch.tensor([[1024.0] * 2 + [0.0] * 2
                                       + [1024.0] * 2] * 4, device="cuda")}
    t = torch.full((4,), 500.0, device="cuda")
    result = {"card": card, "one device": measure(
        lambda: unet(x, t, ehs, added_cond=added), card,
        "SDXL 2 x 1024^2 CFG forward, one device")}
    stats: dict = {}
    real = timed_exchange(stats)
    try:
        for label, sp, tp in (("tp=2", 1, 2), ("sp=2", 2, 1)):
            group = ShardGroup(["cuda:0"] * 2, sp=sp, tp=tp)
            den = ShardedDenoiser(unet, group)
            if sp == 1:
                def fn(den=den):
                    den(x, t, ehs, added_cond=added)
            else:
                def fn(den=den, group=group):
                    group.run(lambda r: den(
                        shard_rows(x, group, "sp", 1, r), t, ehs,
                        added_cond=added, ctx=ShardContext(group)))
            result[label] = measure(fn, card, f"SDXL 2 x 1024^2 CFG "
                                    f"forward, {label} on card 0", stats)
            group.close()
    finally:
        ShardGroup._exchange = real
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time K4 (gn_silu_halo) and K5 (flash_cross_short) of one checkout at
chip_smoke.py's timed shapes, on one CUDA card.

    python3 scripts/time_k4_k5.py [--root DIR] [--out FILE]

``sduss_tpu_torch`` is imported from DIR (default: this checkout); the
shapes, the inputs' metadata and the timer come from this checkout's
chip_smoke.py.  So two checkouts -- this one and a parent commit unpacked
with ``git archive`` into a git-ignored directory such as ``build/`` -- are
timed by the same code at the same shapes.  Run it for each checkout in
turns (parent, this, this, parent) within one call to compare the two
versions of the kernels on one card.  Inputs are N(0, 1) bf16 from a fixed
seed; K4 runs on the CFG-doubled patch metadata of chip_smoke's SDXL and
SD-1.5 mixed phases with bf16 GroupNorm parameters, its moments computed
once outside the timed calls.  Two times per shape: ``call`` (CUDA events
around ``--iters`` wrapper calls: at small shapes the wrapper's host work
sets it) and ``device`` (the kernel's own time, from ``torch.profiler``
over as many calls).  At each K5 shape the same two times of
``scaled_dot_product_attention`` on the same inputs (timed only; the
package never calls it; device time = all its kernels).  Prints one JSON
line: the card, the root and the times in ms per call at each shape.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose sduss_tpu_torch is timed")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    import sduss_tpu_torch
    if not Path(sduss_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"sduss_tpu_torch imported from "
                         f"{sduss_tpu_torch.__file__}, not {root}")
    from sduss_tpu_torch.ops.flash import flash_cross_short
    from sduss_tpu_torch.ops.gn_halo import gn_silu_halo, moments

    if not torch.cuda.is_available():
        raise SystemExit("time_k4_k5: no CUDA device")
    spec = importlib.util.spec_from_file_location("smoke_shapes",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.configure_numerics()
    card = smoke.card_line()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def times(fn, kernel=None) -> dict:
        """Call and device ms; device = the kernels named ``kernel`` (one a
        call), or every kernel when ``kernel`` is None."""
        call = smoke.cuda_ms(fn, args.iters)
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(args.iters):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and (kernel is None or kernel in e.name)]
        if kernel is not None and len(us) != args.iters:
            raise RuntimeError(f"{len(us)} {kernel} launches profiled, not "
                               f"{args.iters}")
        return {"call": call, "device": sum(us) / 1e3 / args.iters}

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    k5, sdpa = {}, {}
    for b, lq, lk, d, h in smoke.K5_TIMED:
        q, k, v = randn(b, lq, d), randn(b, lk, d), randn(b, lk, d)
        scale = (d // h) ** -0.5
        k5[str((b, lq, lk, d, h))] = times(
            lambda: flash_cross_short(q, k, v, h, scale), "cross_short_kernel")
        sdpa[str((b, lq, lk, d, h))] = times(
            lambda: smoke.sdpa(q, k, v, h, scale))
    k4 = {}
    for meta, shapes in ((smoke.mixed_meta(), smoke.K4_SHAPES),
                         (smoke.mixed_meta("sd15", smoke.SD15_MIXED_REQUESTS),
                          smoke.SD15_K4_SHAPES)):
        image_id = torch.from_numpy(meta.image_id).cuda()
        neighbors = torch.from_numpy(meta.neighbors).cuda()
        for s, c in shapes:
            x = randn(meta.p_pad, c, s, s)
            w, bias = randn(c), randn(c)
            mean, var = moments(x, image_id, meta.i_pad, 32)
            rstd = torch.rsqrt(var + 1e-5)
            k4[str((meta.p_pad, s, c))] = times(
                lambda: gn_silu_halo(x, image_id, neighbors, mean, rstd, w,
                                     bias), "gn_halo_kernel")
    result = {"card": card, "root": str(root), "k5_ms": k5, "sdpa_ms": sdpa,
              "k4_ms": k4}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()

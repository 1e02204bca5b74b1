#!/usr/bin/env python3
"""Attribute the device time of PyTorch's generic elementwise, copy and
reduction kernels to the port's code that launches them, on one CUDA card.

    python3 scripts/attribute_elementwise.py [--root DIR] [--requests 12]
        [--steps 26] [--out FILE]

``sduss_tpu_torch`` is imported from DIR (default: this checkout), so a
parent commit unpacked with ``git archive`` into a git-ignored directory
is measured by the same code.  The run: SDXL at full width (random bf16
weights from seed 0) serves ``--requests`` 1024^2 requests at once on the
dense path under ``CacheConfig.production("sdxl")`` (the serving preset:
row warmup's partial steps, shallow steps with the hybrid gate, a full
step at the interval), decodes them, and ``torch.profiler`` records the
whole call after one warm-up call.  Every kernel is put in a class by its
name (``copy``: PyTorch's copy kernels, the dtype casts and
``.contiguous()``; ``elementwise``; ``reduce``; ``other``) and in a source
by the innermost of these ranges around its launch: ``group_norm`` (every
``layers.GroupNorm``, the UNet's and the VAE's), ``drift`` (the deep
cache's ``_drift_logit``), ``layer_norm`` (``layers.LayerNorm``),
``geglu`` (``GEGLU``), ``unet_other`` / ``vae_other`` (the rest of the
UNet forward / the decode) and ``outside``.  Prints one JSON line: the
card, the root, seconds by (source, class), the aten ops that launched
the most copy/elementwise/reduce time, the device seconds of the port's
own kernels by name (they launch outside any aten op, so the sources do
not see them) and the sixteen kernels with the most device time.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CLASSES = ("copy", "elementwise", "reduce", "other")


def kernel_class(name: str) -> str:
    n = name.lower()
    if "copy" in n and "elementwise" in n:
        return "copy"
    if "elementwise" in n:
        return "elementwise"
    if "reduce_kernel" in n:
        return "reduce"
    return "other"


def labelled(fn, label: str):
    import torch

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.profiler.record_function(f"src::{label}"):
            return fn(*args, **kwargs)
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE,
                    help="checkout whose sduss_tpu_torch is measured")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--steps", type=int, default=26)
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path.insert(0, str(root))

    import torch

    import sduss_tpu_torch
    if not Path(sduss_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"sduss_tpu_torch imported from "
                         f"{sduss_tpu_torch.__file__}, not {root}")
    if not torch.cuda.is_available():
        raise SystemExit("attribute_elementwise: no CUDA device")
    from sduss_tpu_torch import configure_numerics
    from sduss_tpu_torch.cache.manager import BlockCache
    from sduss_tpu_torch.config import CacheConfig
    from sduss_tpu_torch.entrypoints.offline import (DiffusionPipeline,
                                                     default_config)
    from sduss_tpu_torch.models import layers, unet, vae
    from sduss_tpu_torch.models.registry import ModelBundle

    configure_numerics()
    layers.GroupNorm.forward = labelled(layers.GroupNorm.forward,
                                        "group_norm")
    layers.LayerNorm.forward = labelled(layers.LayerNorm.forward,
                                        "layer_norm")
    unet.GEGLU.forward = labelled(unet.GEGLU.forward, "geglu")
    BlockCache._drift_logit = labelled(BlockCache._drift_logit, "drift")
    unet.UNet2DConditionModel.forward = labelled(
        unet.UNet2DConditionModel.forward, "unet_other")
    vae.AutoencoderKL.decode = labelled(vae.AutoencoderKL.decode,
                                        "vae_other")

    bundle = ModelBundle("sdxl", dtype=torch.bfloat16, device="cuda")
    bundle.init_random(seed=0)
    config = default_config("sdxl", dtype="bfloat16", seed=0)
    config.scheduler.use_mixed_resolution = False
    config.scheduler.max_batch_size = max(args.requests,
                                          config.scheduler.max_batch_size)
    config.engine.async_postprocess = False
    config.cache = CacheConfig.production("sdxl")
    pipe = DiffusionPipeline(config=config, device="cuda", bundle=bundle)
    prompts = [f"a photo of object {i}" for i in range(args.requests)]

    def run():
        pipe.generate(prompts, resolution=1024,
                      num_inference_steps=args.steps, seed=7)
        torch.cuda.synchronize()

    run()  # kernels built, allocator warm
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()

    by = collections.defaultdict(float)
    launchers = collections.defaultdict(float)
    for ev in prof.events():
        kernels = getattr(ev, "kernels", None) or []
        if not kernels:
            continue
        src, op, node = "outside", ev.name, ev
        chain = []
        while node is not None:
            if node.name.startswith("src::"):
                src = node.name[5:]
                break
            chain.append(node.name)
            node = node.cpu_parent
        for k in kernels:
            cls = kernel_class(k.name)
            by[src, cls] += k.duration / 1e6
            if cls != "other":
                top = chain[-1] if chain else op
                launchers[f"{src}: {top} > {op} [{cls}]"] += k.duration / 1e6
    # the port's own kernels launch through ctypes, outside any aten op:
    # their time is read by kernel name
    own = collections.defaultdict(float)
    kernels_by_name = {}
    for ev in prof.key_averages():
        m = re.search(r"\(anonymous namespace\)::(\w+)", ev.key)
        if m:
            own[m.group(1)] += ev.device_time_total / 1e6
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels_by_name[ev.key[:90]] = ev.device_time_total / 1e6
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    sources = sorted({s for s, _ in by})
    out = {
        "card": card, "root": str(root), "requests": args.requests,
        "steps": args.steps,
        "seconds": {s: {c: round(by[s, c], 6) for c in CLASSES}
                    for s in sources},
        "class_totals": {c: round(sum(by[s, c] for s in sources), 6)
                         for c in CLASSES},
        "top_launchers": [[k, round(v, 6)] for k, v in sorted(
            launchers.items(), key=lambda kv: -kv[1])[:24]],
        "own_kernels": {k: round(v, 6) for k, v in sorted(own.items())},
        "top_kernels": [[k, round(v, 6)] for k, v in sorted(
            kernels_by_name.items(), key=lambda kv: -kv[1])[:16]],
    }
    line = json.dumps(out)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the time of a denoise step goes in the PyTorch/CUDA port.

    python3 scripts/profile_torch_step.py [--family sdxl|sd3|sd15]
                                          [--steps 3] [--out FILE.json]

Needs one CUDA card.  Builds the full-width pipeline of ``sduss_tpu_torch``
for the family (random bf16 weights from seed 0, TF32 off; SDXL: fp32
VAE; SD3.5-medium: bf16 tiled VAE; SD-1.5: bf16 VAE) and measures,
printing one line each:

  1. ``--steps`` denoise steps at the family's size (1024^2; SD-1.5
     512^2), batch 2 (4 denoiser rows with CFG) under ``torch.profiler``:
     wall ms per step (CUDA events), device-busy ms per step (the union of
     kernel intervals) and device ms per op class;
  2. prepare (the family's text encoders over 2 prompts and 2 negatives,
     latent init) and the VAE decode of one image at the family's two
     largest sizes (1024^2 and 768^2; SD-1.5 768^2 and 512^2);
  3. that step at batch 1, 2 and 4 (SD3: 1 and 2, since the plain
     version's float32 scores of batch 4 take 15 GB a copy) with every
     long unmasked attention through its kernel (SDXL, SD-1.5: K1; SD3:
     flash_mha) and through its plain PyTorch version, alternated kernel,
     plain, plain, kernel.  For the plain phase only, this script rebinds
     the dispatcher's kernel entry (``ops.attention.flash_mha_fused`` /
     ``flash_mha``) to the plain version; the package itself has no such
     switch;
  4. the mixed step (SDXL: 768^2 + 3 x 1024^2, one patched UNet forward;
     SD3: 512^2 + 2 x 1024^2, one padded-token MMDiT forward; SD-1.5:
     256^2 + 512^2 + 768^2, one patched UNet forward;
     ``denoise_step_mixed``) under the profiler as in 1, and its wall ms
     against the same requests as dense per-resolution forwards
     (``denoise_step``), alternated mixed, dense, dense, mixed;
  5. SDXL and SD-1.5: the dense batch-2 step and the mixed step with
     short-KV attention (text cross-attention) on K5 and on the plain
     route the dispatcher took before it routed K5 (``layers.attention``:
     float32 scores and softmax), alternated K5, plain, plain, K5; as in 3
     the script rebinds ``ops.attention.flash_cross_short`` for the plain
     phase only.

The last line is a JSON object with every number; ``--out`` also writes it
to a file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from sduss_tpu_torch.request import Request, SamplingParams  # noqa: E402
from sduss_tpu_torch import configure_numerics  # noqa: E402
from sduss_tpu_torch.entrypoints.offline import default_config  # noqa: E402
from sduss_tpu_torch.models import layers  # noqa: E402
from sduss_tpu_torch.ops import attention as attn_ops  # noqa: E402
from sduss_tpu_torch.ops import flash  # noqa: E402
from sduss_tpu_torch.pipelines import build_pipeline  # noqa: E402

# the dense step's resolution, and the two decode sizes, per family
RES = {"sdxl": 1024, "sd3": 1024, "sd15": 512}
DECODE_RES = {"sdxl": (1024, 768), "sd3": (1024, 768), "sd15": (768, 512)}
STEPS_PER_REQUEST = 50  # sampler table long enough for every timed step

# op classes by kernel name, first match wins (the flash template's name
# carries <head dim, masked>, e.g. mha_fused_kernel<40, true>)
OP_CLASSES = [
    ("masked flash attention", (", true>(__nv_bfloat16",)),
    ("unmasked flash (K1, flash_mha)", ("mha_fused",)),
    ("K5 flash_cross_short", ("cross_short",)),
    ("K4 gn+silu+halo", ("gn_halo",)),
    ("convolution", ("conv", "fprop", "dgrad", "wgrad", "implicit")),
    ("matmul", ("gemm", "xmma", "cutlass", "cublas", "nvjet")),
    ("reduction / softmax / cat", ("reduce", "softmax", "cat", "norm")),
    ("elementwise / copy", ("elementwise", "copy", "vectorized", "unrolled")),
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call by CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def prepared(pipe, batch: int, res: int, tag: str = "r") -> list:
    reqs = [Request(f"{tag}{i}", SamplingParams(
        prompt=f"a photo of object {i}", negative_prompt="blurry",
        resolution=res, num_inference_steps=STEPS_PER_REQUEST, seed=i))
        for i in range(batch)]
    pipe.prepare(reqs)
    return reqs


def op_class(name: str) -> str:
    low = name.lower()
    for cls, keys in OP_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def profile_step(pipe, res: int, steps: int) -> dict:
    reqs = prepared(pipe, 2, res, tag="prof")
    return profile(lambda: pipe.denoise_step({res: reqs}), steps)


def profile(step, steps: int) -> dict:
    """Wall ms per step, device-busy ms per step and device ms by op class
    of ``steps`` calls of ``step``."""
    wall = cuda_ms(step, steps)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler saw no device kernels")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    classes: dict = {}
    by_name: dict = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        cls = op_class(e.name)
        ms, n = classes.get(cls, (0.0, 0))
        classes[cls] = (ms + us / 1e3 / steps, n + 1)
        by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3 / steps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:15]
    return {"wall_ms": wall, "busy_ms": busy_us / 1e3 / steps,
            "classes": {c: {"ms": ms, "calls": n // steps}
                        for c, (ms, n) in sorted(classes.items(),
                                                 key=lambda kv: -kv[1][0])},
            "top_kernels": [{"name": n[:120], "ms": ms} for n, ms in top]}


def stage_times(pipe, family: str) -> dict:
    prep = cuda_ms(lambda: prepared(pipe, 2, RES[family], tag="prep"), 3)
    out = {"prepare_2_requests_ms": prep}
    for res in DECODE_RES[family]:
        lat = prepared(pipe, 1, res=res, tag=f"dec{res}")[0].latents
        out[f"vae_decode_{res}_ms"] = cuda_ms(lambda: pipe._decode_fn(lat), 3)
    return out


# the dispatcher entry of each family's long unmasked attention, and the
# mixed batch of its serving phase
KERNEL_ENTRY = {"sdxl": ("flash_mha_fused", flash.flash_mha_fused_reference),
                "sd3": ("flash_mha", flash.flash_mha_reference),
                "sd15": ("flash_mha_fused", flash.flash_mha_fused_reference)}
MIXED = {"sdxl": [768, 1024, 1024, 1024], "sd3": [512, 1024, 1024],
         "sd15": [256, 512, 768]}
AB_BATCHES = {"sdxl": (1, 2, 4), "sd3": (1, 2), "sd15": (1, 2, 4)}


def kernel_vs_plain(pipe, family: str, steps: int) -> dict:
    """Step ms with the kernel and with its plain version, alternated on
    one card."""
    name, plain = KERNEL_ENTRY[family]
    kernel = getattr(attn_ops, name)
    out = {}
    res = RES[family]
    for batch in AB_BATCHES[family]:
        reqs = prepared(pipe, batch, res, tag=f"ab{batch}")
        step = lambda: pipe.denoise_step({res: reqs})  # noqa: E731
        row = {"kernel": [], "plain": []}
        for variant in ("kernel", "plain", "plain", "kernel"):
            setattr(attn_ops, name, plain if variant == "plain" else kernel)
            try:
                row[variant].append(cuda_ms(step, steps))
            finally:
                setattr(attn_ops, name, kernel)
        out[f"batch{batch}"] = row
    return out


def plain_route(q, k, v, num_heads, scale):
    """The route of short-KV attention before K5 was routed: the plain
    attention layer."""
    return layers.attention(q, k, v, num_heads, scale=scale)


def route_vs_plain(pipe, family: str, steps: int) -> dict:
    """Wall ms of the dense batch-2 step and the mixed step with short-KV
    attention on K5 and on the plain route, alternated on one card."""
    kernel = attn_ops.flash_cross_short
    res, mix = RES[family], MIXED[family]
    dense = prepared(pipe, 2, res, tag="route")
    by_res = {r: prepared(pipe, mix.count(r), res=r, tag=f"rt{r}_")
              for r in sorted(set(mix))}
    steps_of = {"dense": lambda: pipe.denoise_step({res: dense}),
                "mixed": lambda: pipe.denoise_step_mixed(by_res)}
    out = {}
    for name, step in steps_of.items():
        row = {"k5": [], "plain": []}
        for variant in ("k5", "plain", "plain", "k5"):
            attn_ops.flash_cross_short = (plain_route if variant == "plain"
                                          else kernel)
            try:
                row[variant].append(cuda_ms(step, steps))
            finally:
                attn_ops.flash_cross_short = kernel
        out[name] = row
    return out


def mixed_vs_dense(pipe, mixed: list, steps: int) -> dict:
    """The mixed step's profile, and its wall ms against two dense
    per-resolution forwards of the same requests, alternated."""
    by_res: dict = {}
    for res in sorted(set(mixed)):
        by_res[res] = prepared(pipe, mixed.count(res), res=res, tag=f"mx{res}_")
    prof = profile(lambda: pipe.denoise_step_mixed(by_res), steps)
    row = {"mixed": [], "dense": []}
    for variant in ("mixed", "dense", "dense", "mixed"):
        fn = (pipe.denoise_step_mixed if variant == "mixed"
              else pipe.denoise_step)
        row[variant].append(cuda_ms(lambda: fn(by_res), steps))
    return {"profile": prof, "mixed_vs_dense": row}


def print_profile(prof: dict) -> None:
    for cls, v in prof["classes"].items():
        print(f"  {cls:28s} {v['ms']:8.2f} ms/step  {v['calls']:5d} kernels "
              f"{v['ms'] / prof['busy_ms']:6.1%}")
    for k in prof["top_kernels"]:
        print(f"    {k['ms']:8.2f} ms/step  {k['name']}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=sorted(KERNEL_ENTRY), default="sdxl")
    ap.add_argument("--steps", type=int, default=3,
                    help="timed denoise steps per measurement")
    ap.add_argument("--out", type=Path, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_step: no CUDA device")
    configure_numerics()
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    fam = args.family
    pipe = build_pipeline(default_config(fam, dtype="bfloat16", seed=0),
                          torch.device("cuda"))
    torch.cuda.synchronize()
    print(f"{fam} pipeline built in {time.perf_counter() - t0:.1f} s")

    res = RES[fam]
    prof = profile_step(pipe, res, args.steps)
    print(f"step {res}^2 batch 2: wall {prof['wall_ms']:.2f} ms, device busy "
          f"{prof['busy_ms']:.2f} ms ({prof['busy_ms'] / prof['wall_ms']:.1%}) "
          f"[{card}]")
    print_profile(prof)
    stages = stage_times(pipe, fam)
    print("stages: " + ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
          + f" [{card}]")
    ab = kernel_vs_plain(pipe, fam, args.steps)
    for batch, row in ab.items():
        print(f"step {res}^2 {batch}: {KERNEL_ENTRY[fam][0]} "
              + "/".join(f"{x:.2f}" for x in row["kernel"]) + " ms, plain "
              + "/".join(f"{x:.2f}" for x in row["plain"]) + f" ms [{card}]")
    mix = MIXED[fam]
    mixed = mixed_vs_dense(pipe, mix, args.steps)
    mp = mixed["profile"]
    key = ";".join(f"{r}x{mix.count(r)}" for r in sorted(set(mix)))
    print(f"mixed step {key}: wall {mp['wall_ms']:.2f} ms, device busy "
          f"{mp['busy_ms']:.2f} ms ({mp['busy_ms'] / mp['wall_ms']:.1%}) "
          f"[{card}]")
    print_profile(mp)
    row = mixed["mixed_vs_dense"]
    print(f"mixed {key}: one forward " + "/".join(f"{x:.2f}" for x in row["mixed"])
          + " ms, dense per-resolution forwards "
          + "/".join(f"{x:.2f}" for x in row["dense"]) + f" ms [{card}]")
    route = {}
    if fam != "sd3":  # the MMDiT has no short-KV attention
        route = route_vs_plain(pipe, fam, args.steps)
        for name, row in route.items():
            print(f"{name} step, short-KV attention on K5 "
                  + "/".join(f"{x:.2f}" for x in row["k5"])
                  + " ms, on the plain route "
                  + "/".join(f"{x:.2f}" for x in row["plain"])
                  + f" ms [{card}]")
    result = {"card": card, "family": fam, "profile": prof, "stages": stages,
              "kernel_vs_plain": ab, "mixed": mixed, "route_vs_plain": route}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()

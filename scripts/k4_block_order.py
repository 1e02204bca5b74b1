#!/usr/bin/env python3
"""K4's block order (``csrc/gn_halo.cu``, gn_silu_halo) on the card:
blocks numbered channel-run-fastest against patch-fastest.

    python3 scripts/k4_block_order.py [--rounds 5] [--out FILE.json]

Needs one CUDA card and nvcc.  Writes two copies of the source under
``build/tune_flash/``, one per order (channel-run-fastest: the blocks in
flight cover all channel runs of a few patches, and consecutive blocks
write consecutive memory; patch-fastest: they cover one channel run of
many patches, so the planes whose edges a block reads are read by their
own blocks at about the same time), compiles both (`build_all` of
scripts/tune_flash_shapes.py), holds both against the plain version at
chip_smoke.py's K4 shapes (chip_smoke's bound, image borders exactly 0)
and times both with CUDA events, ``--rounds`` times in alternating
order, reporting the median.
The package itself has no switch for this.  The last line is a JSON
object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import tune_flash_shapes as tf  # noqa: E402
import chip_smoke as smoke  # noqa: E402
from sduss_tpu_torch.ops import _build  # noqa: E402
from sduss_tpu_torch.ops.gn_halo import (gn_silu_halo_reference,  # noqa: E402
                                         moments)

SRC = _build.SRC_DIR / "gn_halo.cu"
ORDERS = {
    "k4_channel_fastest": (
        "  const int runs = (C + run - 1) / run;"
        "  // channel-run-fastest order\n"
        "  const int p = blockIdx.x / runs;\n"
        "  const int c0 = (blockIdx.x % runs) * run;\n"),
    "k4_patch_fastest": (
        "  const int p = blockIdx.x % P;  // patch-fastest order\n"
        "  const int c0 = (blockIdx.x / P) * run;\n"),
}


def load(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sduss_gn_silu_halo.argtypes = [p] * 8 + [i] * 5 + [p]
    return lib


def cases() -> list:
    """(shape, launcher maker, check) at chip_smoke's K4 shapes on its
    SDXL and SD-1.5 mixed phases' patch metadata, inputs from seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for meta, shapes in ((smoke.mixed_meta(), smoke.K4_SHAPES),
                         (smoke.mixed_meta("sd15", smoke.SD15_MIXED_REQUESTS),
                          smoke.SD15_K4_SHAPES)):
        image_id = torch.from_numpy(meta.image_id).cuda()
        nb = torch.from_numpy(meta.neighbors).cuda()
        for s, c in shapes:
            x = (1.5 * torch.randn(meta.p_pad, c, s, s, generator=gen,
                                   device="cuda") + 0.2).to(torch.bfloat16)
            w, b = (torch.randn(c, generator=gen, device="cuda").to(
                torch.bfloat16) for _ in range(2))
            mean, var = moments(x, image_id, meta.i_pad, 32)
            rstd = torch.rsqrt(var + 1e-5)
            ref = gn_silu_halo_reference(x, image_id, nb, mean, rstd, w, b)
            y = torch.empty_like(ref)

            def launcher(lib, x=x, image_id=image_id, nb=nb, mean=mean,
                         rstd=rstd, w=w, b=b, y=y, c=c, s=s):
                return lambda: lib.sduss_gn_silu_halo(
                    x.data_ptr(), image_id.data_ptr(), nb.data_ptr(),
                    mean.data_ptr(), rstd.data_ptr(), w.data_ptr(),
                    b.data_ptr(), y.data_ptr(), x.shape[0], c, s, 32, 1,
                    torch.cuda.current_stream().cuda_stream)

            def check(y=y, ref=ref, nb=nb):
                err = (y.float() - ref.float()).abs().max().item()
                rel = err / ref.float().abs().max().item()
                borders = bool((y[nb[:, 0] < 0][:, :, 0, :] == 0).all()
                               and (y[nb[:, 2] < 0][:, :, :, 0] == 0).all())
                return rel, rel <= smoke.K4_MAX_REL and borders

            out.append(((meta.p_pad, s, c), launcher, check))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("k4_block_order: no CUDA device")
    card = smoke.card_line()
    src = SRC.read_text()
    shipped = [lines for lines in ORDERS.values() if src.count(lines) == 1]
    if len(shipped) != 1:
        raise RuntimeError(f"no block-order lines in {SRC}")
    built = tf.build_all([(name, src.replace(shipped[0], lines))
                          for name, lines in ORDERS.items()])
    runs = list(built)
    libs = {name: load(built[name][0]) for name in runs}
    todo = cases()
    times = {name: [[] for _ in todo] for name in runs}
    checks = {}
    for name in runs:
        checks[name] = []
        for _, launcher, check in todo:
            tf.launched(launcher(libs[name]))()
            torch.cuda.synchronize()
            checks[name].append(check())
    for rnd in range(args.rounds):
        for name in (runs if rnd % 2 == 0 else runs[::-1]):
            for i, (_, launcher, _) in enumerate(todo):
                times[name][i].append(
                    tf.cuda_ms(tf.launched(launcher(libs[name])), args.iters))
    results = []
    for name in runs:
        for i, (shape, _, _) in enumerate(todo):
            ms = sorted(times[name][i])
            med = ms[len(ms) // 2]
            rel, ok = checks[name][i]
            results.append({"order": name, "shape": shape, "ms_median": med,
                            "ms_all": ms, "max_rel": rel, "ok": ok})
            print(f"{name} (P, s, C) {shape}: median {med:.4f} ms of "
                  f"{len(ms)} rounds (min {ms[0]:.4f}, max {ms[-1]:.4f}), "
                  f"max_rel {rel:.3e}, {'ok' if ok else 'FAILS'} [{card}]")
    result = {"card": card, "results": results}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()

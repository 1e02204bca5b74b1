#!/usr/bin/env python3
"""Block shapes of the flash template (``csrc/flash_fused.cu``) on the card.

    python3 scripts/tune_flash_shapes.py [--hd 40 64 80 160] [--out FILE.json]

Needs one CUDA card and nvcc.  For every candidate shape of a head dim (warps
per block, m16 row tiles per warp, key-tile rows, ring stages) the script writes a copy of the source under
``build/tune_flash/`` with that head dim's ``Shape<hd>`` line replaced,
compiles each copy into its own library (one nvcc per copy, all started
together, the package's flags), prints ptxas's registers, spills and shared
memory of that head dim's two instantiations, and then, for each library
in turn, holds the unmasked and the masked kernel against their plain
versions (chip_smoke.py's bounds) at the serving shapes of that head dim;
then it times every library at those shapes with CUDA events, ``--rounds``
times in alternating order (forward, then backward over the variants), and
reports the median.  The source as it stands runs too, as
"shipped".  The package itself has no switch for any of this: the copies
are the only place a shape changes.  The last line is a JSON object with
every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from sduss_tpu_torch.ops import _build  # noqa: E402
from sduss_tpu_torch.ops.flash import (flash_mha_fused_reference,  # noqa: E402
                                       flash_mha_masked_reference)

OUT_DIR = ROOT / "build" / "tune_flash"
SRC = _build.SRC_DIR / "flash_fused.cu"
MAX_REL, RMS_REL = 2.0 ** -6, 5e-3  # chip_smoke.py's K1 bounds
# (warps, MT, BK, stages) candidates per head dim
CANDIDATES = {
    40: [(4, 1, 64, 2), (4, 2, 64, 2), (8, 1, 64, 2),
         (4, 2, 64, 3), (4, 1, 64, 3), (4, 2, 64, 4)],
    64: [(4, 1, 64, 2), (4, 2, 64, 2), (8, 1, 64, 2),
         (4, 2, 64, 3), (4, 1, 64, 3), (4, 2, 64, 4),
         (8, 1, 64, 3)],
    80: [(4, 1, 64, 2), (4, 2, 64, 2), (8, 1, 64, 2),
         (4, 1, 64, 3), (4, 2, 64, 3)],
    160: [(4, 1, 64, 2), (4, 1, 32, 2), (4, 1, 64, 3),
          (8, 1, 64, 2), (8, 1, 32, 2)],
}
# the serving shapes of each head dim: unmasked (B, Lq, Lk, D, H) and
# masked (B, L, D, H, batch rows with no valid key)
SHAPES = {
    40: ([(2, 4096, 4096, 320, 8)], [(3, 9216, 320, 8, 1)]),
    64: ([(2, 4096, 4096, 640, 10), (2, 1024, 1024, 1280, 20),
          (2, 4429, 4429, 1536, 24)], [(8, 4096, 640, 10, 2),
                                       (8, 4096, 1536, 24, 2)]),
    80: ([(2, 1024, 1024, 640, 8)], [(3, 1024, 640, 8, 1)]),
    160: ([(2, 256, 256, 1280, 8)], [(3, 576, 1280, 8, 1)]),
}


def variant_source(hd: int, shape) -> str:
    warps, mt, bk, stages = shape
    src = SRC.read_text()
    line = (f"template <> struct Shape<{hd}> {{ static constexpr int WARPS = "
            f"{warps}, MT = {mt}, BK = {bk}, STAGES = {stages}; }};")
    new, n = re.subn(rf"template <> struct Shape<{hd}> \{{[^\n]*\}};", line, src)
    if n != 1:
        raise RuntimeError(f"no Shape<{hd}> line in {SRC}")
    return new


def build_all(jobs):
    """jobs: [(name, source text)] -> {name: (library path, ptxas usage)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, text in jobs:
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        lib = OUT_DIR / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.SRC_DIR), "-shared",
             "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (lib, _build.ptxas_usage(log))
    return out


def load(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sduss_flash_mha_fused.argtypes = [p, p, p, p, i, i, i, i, i,
                                          ctypes.c_float, p]
    lib.sduss_flash_mha_masked.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                           ctypes.c_float, p]
    return lib


def cuda_ms(fn, iters: int) -> float:
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


def errors(out, ref) -> tuple:
    diff, ref = out.float() - ref.float(), ref.float()
    return ((diff.abs().max() / ref.abs().max()).item(),
            (diff.norm() / ref.norm()).item())


def inputs(hd: int) -> list:
    """The head dim's serving shapes as (tag, shape, launcher maker, check,
    FLOP) with their inputs made once, from seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 1.0 / math.sqrt(hd)
    scale_log2 = scale / math.log(2.0)
    cases = []
    unmasked, masked = SHAPES[hd]
    for b, lq, lk, d, h in unmasked:
        q = torch.randn(b, lq, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, lk, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out = torch.empty_like(q)
        ref = flash_mha_fused_reference(q, k, v, h, scale)

        def launcher(lib, q=q, k=k, v=v, out=out, b=b, lq=lq, lk=lk, d=d,
                     h=h):
            return lambda: lib.sduss_flash_mha_fused(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                lq, lk, d, h, scale_log2,
                torch.cuda.current_stream().cuda_stream)

        def check(out=out, ref=ref):
            max_rel, rms = errors(out, ref)
            return max_rel, rms, max_rel <= MAX_REL and rms <= RMS_REL

        cases.append(("unmasked", [b, lq, lk, d, h], launcher, check,
                      4.0 * b * lq * lk * d))
    for b, length, d, h, dead in masked:
        q, k, v = (torch.randn(b, length, d, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        mask = torch.ones(b, length, dtype=torch.bool, device="cuda")
        mask[b - dead:] = False
        out = torch.empty_like(q)
        live = mask.any(dim=1)
        ref = flash_mha_masked_reference(q, k, v, mask, h, scale)[live]

        def launcher(lib, q=q, k=k, v=v, mask=mask, out=out, b=b, n=length,
                     d=d, h=h):
            return lambda: lib.sduss_flash_mha_masked(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(),
                out.data_ptr(), b, n, n, d, h, scale_log2,
                torch.cuda.current_stream().cuda_stream)

        def check(out=out, ref=ref, live=live):
            max_rel, rms = errors(out[live], ref)
            return (max_rel, rms, max_rel <= MAX_REL and rms <= RMS_REL
                    and bool((out[~live] == 0).all()))

        cases.append(("masked", [b, length, d, h, dead], launcher, check,
                      4.0 * d * length * mask.sum().item()))
    return cases


def launched(fn):
    """Raise if a C entry returned a CUDA error."""
    def run():
        err = fn()
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
    return run


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hd", type=int, nargs="+", default=sorted(CANDIDATES))
    ap.add_argument("--iters", type=int, default=20,
                    help="launches per timing")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timings per variant and shape, in alternating order")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_flash_shapes: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    jobs = [("shipped", SRC.read_text())]
    names = {}
    for hd in args.hd:
        for shape in CANDIDATES[hd]:
            name = "hd{}_w{}_mt{}_bk{}_s{}".format(hd, *shape)
            names[name] = (hd, shape)
            jobs.append((name, variant_source(hd, shape)))
    built = build_all(jobs)
    results = []
    for hd in args.hd:
        runs = ["shipped"] + [n for n, (h, _) in names.items() if h == hd]
        cases = inputs(hd)
        libs = {name: load(built[name][0]) for name in runs}
        times = {name: [[] for _ in cases] for name in runs}
        checks = {}
        for name in runs:
            usage = [u for u in built[name][1]
                     if u["kernel"].startswith(f"mha_fused_kernel<{hd}, ")]
            for u in usage:
                print(f"hd {hd} {name}: ptxas {u['kernel']}: "
                      f"{u['registers']} registers, {u['spill_stores']} bytes "
                      f"spill stores, {u['spill_loads']} bytes spill loads")
            checks[name] = []
            for tag, shape, launcher, check, _ in cases:
                launched(launcher(libs[name]))()
                torch.cuda.synchronize()
                checks[name].append(check())
        # rounds over the variants, forward then backward, on one card
        for rnd in range(args.rounds):
            for name in (runs if rnd % 2 == 0 else runs[::-1]):
                for i, (_, _, launcher, _, _) in enumerate(cases):
                    times[name][i].append(
                        cuda_ms(launched(launcher(libs[name])), args.iters))
        for name in runs:
            rows = []
            for i, (tag, shape, _, _, flops) in enumerate(cases):
                ms = sorted(times[name][i])
                med = ms[len(ms) // 2]
                max_rel, rms, ok = checks[name][i]
                rows.append({"shape": shape, "masked": tag == "masked",
                             "ms_median": med, "ms_all": ms,
                             "tflops": flops / med / 1e9, "max_rel": max_rel,
                             "rms_rel": rms, "ok": ok})
                print(f"hd {hd} {name}: {tag} {tuple(shape)} median "
                      f"{med:.4f} ms of {len(ms)} rounds (min {ms[0]:.4f}, "
                      f"max {ms[-1]:.4f}; {flops / med / 1e9:.1f} TFLOP/s), "
                      f"max_rel {max_rel:.3e}, rms {rms:.3e}, "
                      f"{'ok' if ok else 'FAILS THE BOUNDS'} [{card}]")
            shape = None if name == "shipped" else names[name][1]
            results.append({"hd": hd, "variant": name, "shape": shape,
                            "rows": rows, "ptxas": [
                                u for u in built[name][1] if u["kernel"]
                                .startswith(f"mha_fused_kernel<{hd}, ")]})
    result = {"card": card, "results": results}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))


if __name__ == "__main__":
    main()

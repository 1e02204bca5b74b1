#!/usr/bin/env python3
"""Block shapes of K5 (``csrc/flash_cross.cu``, flash_cross_short) on the
card.

    python3 scripts/tune_cross_shapes.py [--hd 40 64 80 160] [--rounds 5]
                                         [--out FILE.json]

Needs one CUDA card and nvcc.  For every candidate block shape (warps per
block, m16 row tiles per warp, query-tile buffers, keys per softmax chunk,
the grid's target of blocks per SM; one shape serves every head dim) the
script writes a copy of the source under ``build/tune_flash/`` with its
block-shape line replaced, compiles each copy into its own library (one
nvcc per copy, all started together, the package's flags; `build_all`
of scripts/tune_flash_shapes.py), and per head dim prints ptxas's
registers and spills of that instantiation, holds each library against
the plain version at that head dim's K5 shapes of chip_smoke.py
(chip_smoke's bounds), then times every library at those shapes with CUDA
events, ``--rounds`` times in alternating order, and reports the median.
The source as it stands runs too, as "shipped".  A candidate that fails
to launch or to match at a head dim is reported and not timed there.  The
package itself has no switch for any of this.  The last line is a JSON
object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import tune_flash_shapes as tf  # noqa: E402
from chip_smoke import K5_SHAPES, card_line  # noqa: E402
from sduss_tpu_torch.ops import _build  # noqa: E402
from sduss_tpu_torch.ops.flash import flash_cross_short_reference  # noqa: E402

SRC = _build.SRC_DIR / "flash_cross.cu"
HEAD_DIMS = (40, 64, 80, 160)
# (warps, row tiles a warp, stages, keys per chunk, blocks per SM)
# candidates; hd 160 needs 64-row query tiles and 2 buffers for 256 keys
# to fit in shared memory (larger ones fail to launch there, and say so)
CANDIDATES = [(4, 1, 2, 128, 8), (4, 1, 2, 64, 8), (4, 1, 2, 32, 8),
              (4, 2, 2, 32, 8), (4, 1, 3, 128, 8), (4, 1, 2, 128, 16),
              (8, 1, 2, 128, 8)]


def variant_source(shape) -> str:
    warps, mt, stages, keys, bps = shape
    line = (f"constexpr int WARPS = {warps}, MT = {mt}, STAGES = {stages}, "
            f"KEYS = {keys}, BLOCKS_PER_SM = {bps};")
    new, n = re.subn(r"constexpr int WARPS = [^\n]*;", line, SRC.read_text())
    if n != 1:
        raise RuntimeError(f"no block-shape line in {SRC}")
    return new


def load(lib_path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(lib_path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sduss_flash_cross_short.argtypes = [p, p, p, p, i, i, i, i, i,
                                            ctypes.c_float, p]
    return lib


def inputs(hd: int) -> list:
    """chip_smoke's K5 shapes of this head dim as (shape, launcher maker,
    check, bytes), inputs made once from seed 0."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    scale = 1.0 / math.sqrt(hd)
    cases = []
    for b, lq, lk, d, h in K5_SHAPES:
        if d // h != hd:
            continue
        q = torch.randn(b, lq, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        k, v = (torch.randn(b, lk, d, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        out = torch.empty_like(q)
        ref = flash_cross_short_reference(q, k, v, h, scale)

        def launcher(lib, q=q, k=k, v=v, out=out, b=b, lq=lq, lk=lk, d=d,
                     h=h):
            return lambda: lib.sduss_flash_cross_short(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                lq, lk, d, h, scale / math.log(2.0),
                torch.cuda.current_stream().cuda_stream)

        def check(out=out, ref=ref):
            max_rel, rms = tf.errors(out, ref)
            return max_rel, rms, max_rel <= tf.MAX_REL and rms <= tf.RMS_REL

        cases.append(([b, lq, lk, d, h], launcher, check,
                      2.0 * (2 * q.numel() + 2 * k.numel())))
    return cases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hd", type=int, nargs="+", default=HEAD_DIMS)
    ap.add_argument("--iters", type=int, default=20,
                    help="launches per timing")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timings per variant and shape, in alternating order")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("tune_cross_shapes: no CUDA device")
    card = card_line()
    print(f"card: {card}")
    names = {"k5_w{}_mt{}_s{}_k{}_b{}".format(*shape): shape
             for shape in CANDIDATES}
    built = tf.build_all([("k5_shipped", SRC.read_text())] + [
        (name, variant_source(shape)) for name, shape in names.items()])
    results = []
    for hd in args.hd:
        runs = ["k5_shipped", *names]
        cases = inputs(hd)
        libs = {name: load(built[name][0]) for name in runs}
        times = {name: [[] for _ in cases] for name in runs}
        checks = {}
        for name in runs:
            for u in built[name][1]:
                if u["kernel"] == f"cross_short_kernel<{hd}>":
                    print(f"hd {hd} {name}: ptxas {u['kernel']}: "
                          f"{u['registers']} registers, {u['spill_stores']} "
                          f"bytes spill stores, {u['spill_loads']} bytes "
                          f"spill loads")
            checks[name] = []
            for _, launcher, check, _ in cases:
                try:
                    tf.launched(launcher(libs[name]))()
                except RuntimeError as err:  # e.g. too much shared memory
                    print(f"hd {hd} {name}: {err}")
                    checks[name].append((None, None, False))
                    continue
                torch.cuda.synchronize()
                checks[name].append(check())
        runs = [name for name in runs if all(ok for *_, ok in checks[name])]
        for rnd in range(args.rounds):
            for name in (runs if rnd % 2 == 0 else runs[::-1]):
                for i, (_, launcher, _, _) in enumerate(cases):
                    times[name][i].append(
                        tf.cuda_ms(tf.launched(launcher(libs[name])),
                                   args.iters))
        for name in runs:
            rows = []
            for i, (shape, _, _, nbytes) in enumerate(cases):
                ms = sorted(times[name][i])
                med = ms[len(ms) // 2]
                max_rel, rms, ok = checks[name][i]
                rows.append({"shape": shape, "ms_median": med, "ms_all": ms,
                             "gb_s": nbytes / med / 1e6, "max_rel": max_rel,
                             "rms_rel": rms, "ok": ok})
                print(f"hd {hd} {name}: {tuple(shape)} median {med:.4f} ms "
                      f"of {len(ms)} rounds (min {ms[0]:.4f}, max "
                      f"{ms[-1]:.4f}; {nbytes / med / 1e6:.1f} GB/s), "
                      f"max_rel {max_rel:.3e}, rms {rms:.3e}, "
                      f"{'ok' if ok else 'FAILS THE BOUNDS'} [{card}]")
            shape = None if name == "k5_shipped" else names[name]
            results.append({"hd": hd, "variant": name, "shape": shape,
                            "cases": rows})
    print(json.dumps({"card": card, "results": results}))


if __name__ == "__main__":
    main()

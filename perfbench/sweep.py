"""Find the knee of an open-loop cell again: the highest arrival rate at
which the program meets the deadline for at least 90% of the requests due
in the window, with no backlog growing over it.

    python3 perfbench/sweep.py --config sdxl-base --traffic sdxl-mix-open \\
        --rates 0.5 1 1.5 2 --seconds 51 --seed 1

One process builds and prewarms the engine of a configuration and an
open-loop mix (``configs/<config>.json``, ``traffic/<traffic>.json``) once,
then sends the mix at each rate in turn (its rate replaced, nothing else),
each pass with its lead-in, window and drain.  For each rate it
prints one JSON line: SLO attainment, p50 and p90 latency, the requests
due in the window, and the backlog (requests sent and not yet returned)
at the window's open and close.  A cell's rate is then written, as a
number, into its mix file (0.8 x the knee); this script changes no
file.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def backlog(records, t: float) -> int:
    return sum(1 for r in records
               if r.sent <= t and (r.done is None or r.done > t))


def sustained(m: dict, open_b: int, close_b: int) -> bool:
    """At least 90% of the window's requests met their deadline, and the
    backlog at the close exceeds the one at the open by no more than a
    tenth of those requests (two at least)."""
    grow = close_b - open_b
    return (m["slo_attainment"] >= 0.9
            and grow <= max(2, 0.1 * m["attempted"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from perfbench.run import cache_env

    cache_env()
    from perfbench.lib import serve, spec, window

    cell = spec.Cell(name=args.traffic,
                     config=spec.config_file(args.config),
                     traffic=spec.traffic_file(args.traffic), chips=1,
                     end_to_end=[], per_layer=[], limits={})
    if cell.traffic["loop"] != "open":
        print("perfbench sweep: not an open-loop cell", file=sys.stderr)
        return 2
    why = spec.check_chips(cell.chips)
    if why is not None:
        print(f"perfbench sweep: {why}", file=sys.stderr)
        return 2
    import torch

    device = torch.device("cuda", 0)
    run_dir = ROOT / ".perfbench_runs"
    run_dir.mkdir(exist_ok=True)
    session = serve.setup(cell, args.seed, False, device, T_START,
                          str(run_dir))
    print(json.dumps({"setup_s": session.setup_s}), flush=True)
    for rate in args.rates:
        mix = dict(cell.traffic, rate_per_s=rate)
        s = serve.drive(session, cell, args.seed, args.seconds, False,
                        device, mix=mix)
        m = window.open_loop(s.records, s.w0, s.w1, cell.config["family"],
                             int(mix["slo"]))
        ob, cb = backlog(s.records, s.w0), backlog(s.records, s.w1)
        print(json.dumps({"rate_per_s": rate, **m, "backlog_open": ob,
                          "backlog_close": cb,
                          "sustained": sustained(m, ob, cb)}), flush=True)
        for lst in (session.probe.steps, session.probe.spans,
                    session.probe.decoded, session.probe.prepared):
            lst.clear()
    session.probe.remove()
    return 0


if __name__ == "__main__":
    sys.exit(main())

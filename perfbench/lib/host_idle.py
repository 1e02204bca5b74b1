"""What the host was doing while the card sat idle, and the cache's step
shares, from the program's own spans (``sduss_tpu_torch/tracing.py``,
recorded when ``engine.collect_data`` is on: the traced run only).

An idle instant is a moment of the window in which no kernel runs (1
minus the union of kernel spans: the rule of ``trace.reduce``).  Each is
put down to the innermost span open at that moment on the engine thread
(the thread that records ``engine.step``), by its self time:

- ``wait``: ``worker.throttle`` and ``worker.wait`` (the host blocked on
  the card or on a pool thread; no metric, the check on the clocks'
  alignment: a host blocked on the card should almost never see it idle);
- ``stage``: a ``stage.*`` span or one of its children (the host enqueues
  more slowly than the card drains);
- ``sched``: ``worker.schedule`` and ``worker.advance``;
- ``engine``: no span (the hand-off through the event loop) or the self
  time of ``engine.step``, ``engine.add`` and ``engine.abort``.

The four parts sum to the idle share.  Spans are stamped with
``perf_counter_ns``, which ``Tracer.offset_ns`` maps onto the profiler's
clock.  The step shares sum the counts on the ``stage.denoise`` spans that
end inside the window (the rule of ``account.py``).  Every number is None
where its spans are missing (a program without the recorder), never 0.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

WAIT = ("worker.throttle", "worker.wait")
SCHED = ("worker.schedule", "worker.advance")
PARTS = ("engine", "sched", "stage", "wait")


def category(name: str, parent: Optional[str]) -> str:
    """The part an instant inside span ``name`` counts to, its parent's
    being ``parent``."""
    if name in WAIT:
        return "wait"
    if name.startswith("stage."):
        return "stage"
    if name in SCHED:
        return "sched"
    return parent or "engine"


def idle_intervals(kernels: Sequence[tuple], w0: float,
                   w1: float) -> List[Tuple[float, float]]:
    """The gaps of ``[w0, w1)`` between the union of the kernels ``(name,
    start, end)``."""
    ks = sorted((max(s, w0), min(e, w1)) for _, s, e in kernels
                if e > w0 and s < w1)
    out, cur = [], w0
    for s, e in ks:
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        out.append((cur, w1))
    return out


def segments(spans: Sequence[tuple], w0: float,
             w1: float) -> List[Tuple[float, float, str, Optional[str]]]:
    """``[w0, w1)`` cut into ``(a, b, part, name)``, each piece labelled by
    the innermost of the nested spans ``(start, end, name)`` of one thread
    open then (``("engine", None)`` where none is)."""
    out: List[Tuple[float, float, str, Optional[str]]] = []
    stack: List[Tuple[float, str, str]] = []   # (end, part, name)
    cur = w0

    def emit(upto: float) -> None:
        nonlocal cur
        a, b = max(cur, w0), min(upto, w1)
        if b > a:
            part, name = ((stack[-1][1], stack[-1][2]) if stack
                          else ("engine", None))
            out.append((a, b, part, name))
        cur = max(cur, upto)

    for t0, t1, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= t0:
            emit(stack[-1][0])
            stack.pop()
        emit(t0)
        stack.append((t1, category(name, stack[-1][1] if stack else None),
                      name))
    while stack:
        emit(stack[-1][0])
        stack.pop()
    emit(w1)
    return out


def split(kernels: Sequence[tuple], spans: Sequence[tuple], w0: float,
          w1: float) -> dict:
    """Idle time of ``[w0, w1)`` by part and by innermost span name, and
    the ten longest gaps with their split by span name; times in the
    kernels' unit."""
    idle = idle_intervals(kernels, w0, w1)
    segs = segments(spans, w0, w1)
    parts = dict.fromkeys(PARTS, 0.0)
    by_name: Dict[str, float] = {}
    gap_names: List[Dict[str, float]] = [{} for _ in idle]
    i = j = 0
    while i < len(idle) and j < len(segs):
        a = max(idle[i][0], segs[j][0])
        b = min(idle[i][1], segs[j][1])
        if b > a:
            _, _, part, name = segs[j]
            name = name or "(no span)"
            parts[part] += b - a
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            gap_names[i][name] = gap_names[i].get(name, 0.0) + (b - a)
        if idle[i][1] <= segs[j][1]:
            i += 1
        else:
            j += 1
    order = sorted(range(len(idle)), key=lambda k: idle[k][0] - idle[k][1])
    return {"window": w1 - w0, "idle": sum(b - a for a, b in idle),
            **parts, "by_name": by_name,
            "gaps": [(idle[k][1] - idle[k][0], gap_names[k])
                     for k in order[:10]]}


def step_counts(records, w0_ns: float, w1_ns: float) -> Dict[str, int]:
    """The counts on the ``stage.denoise`` spans ending in ``[w0, w1)``."""
    out: Dict[str, int] = {}
    for r in records:
        if r.name == "stage.denoise" and w0_ns <= r.t1_ns < w1_ns:
            for k, v in r.attrs.items():
                if isinstance(v, int) and not isinstance(v, bool):
                    out[k] = out.get(k, 0) + v
    return out


def _records():
    try:
        from sduss_tpu_torch import tracing
    except ImportError:  # a program without the recorder
        return None
    return tracing.spans()


def of(run) -> Optional[dict]:
    """The run's host-idle split (shares in %) and step shares, reduced
    once and kept on ``run``; None without spans."""
    if not hasattr(run, "_host_idle"):
        run._host_idle = _reduce(run)
    return run._host_idle


def _reduce(run) -> Optional[dict]:
    records = _records()
    if not records:
        return None
    served = run.served
    w0_ns, w1_ns = served.w0 * 1e9, served.w1 * 1e9
    out: dict = {"counts": step_counts(records, w0_ns, w1_ns)}
    steps = [r for r in records if r.name == "engine.step"
             and w0_ns <= r.t1_ns < w1_ns]
    if served.tracer is None or not steps:
        return out
    threads: Dict[str, int] = {}
    for r in steps:
        threads[r.thread] = threads.get(r.thread, 0) + 1
    engine = max(threads, key=threads.get)
    kernels = served.tracer.kernels()
    off = served.tracer.offset_ns
    spans = [(r.t0_ns + off, r.t1_ns + off, r.name) for r in records
             if r.thread == engine and r.t1_ns > w0_ns and r.t0_ns < w1_ns]
    sp = split(kernels, spans, w0_ns + off, w1_ns + off)
    out["split"] = sp
    for part in PARTS:
        out[part] = sp[part] / sp["window"] * 100.0
    return out


def idle_share(run, part: str) -> Optional[float]:
    h = of(run)
    return None if h is None else h.get(part)


def full_step_share(run) -> Optional[float]:
    """Request-steps whose deep feature was recomputed (mode ``full``,
    and the refreshed rows of ``partial`` steps) over all request-steps
    with a deep mode, in %."""
    h = of(run)
    if h is None:
        return None
    c = h["counts"]
    total = sum(v for k, v in c.items() if k.startswith("mode."))
    if total <= 0:
        return None
    return (c.get("mode.full", 0) + c.get("refreshed", 0)) / total * 100.0


def fresh_pair_share(run) -> Optional[float]:
    """Gated CFG pairs recomputed over the gated pairs scored, in %."""
    h = of(run)
    if h is None or h["counts"].get("pairs", 0) <= 0:
        return None
    c = h["counts"]
    return c.get("pairs_fresh", 0) / c["pairs"] * 100.0

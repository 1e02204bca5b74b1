"""In-process spans and counters of the port, one recorder per process.

The one switch is ``engine.collect_data`` (``--collect-data``):
``Engine.__init__`` turns the recorder on or off from it,
``AsyncEngine.stop`` turns it off, and ``Engine.dump_data`` writes what it
holds (``spans.csv``, ``counters.json``) beside ``request_data.csv`` and
``schedule_rank*.csv``.

- Off, :func:`span` returns one shared no-op context manager and
  :func:`count` and :func:`phase` return at once: nothing is allocated or
  recorded.
- Nothing here reads the device: every attribute is a host value the
  caller already has, and the spans time the host's enqueue of device
  work, not the work itself.
- One clock: spans are stamped with ``time.perf_counter_ns()``, the clock
  a profiler trace is aligned to by a marker kernel launched at a known
  ``perf_counter_ns`` (``perfbench/lib/trace.py``).
- A span holds its name, thread, start and end, the id of its parent (the
  span open on the same thread when it began), the ids of the requests it
  served (its ``reqs``; a child serves its parent's and names none) and a
  few host attributes (``attrs``).  Spans are kept in a bounded deque of
  :data:`MAX_SPANS`; the oldest go first, counted in ``dropped``.
- Counters (:func:`count`) are process-wide totals, and each count is also
  added to the attribute of the same name on the ``stage.*`` span open on
  the calling thread, so that a reader can take them over a window.

The span names are fixed, so that readers can cite them:

=========  =========================================================
engine     ``engine.step``, ``engine.add``, ``engine.abort``
scheduler  ``worker.schedule``, ``worker.advance``
pipelines  ``stage.prepare`` (``prepare.encode``, ``prepare.latents``),
           ``stage.denoise`` (``denoise.batch``, ``denoise.decide``,
           ``denoise.forward`` with its ``cache.gate``,
           ``denoise.update``), ``stage.decode`` (``decode.plan``,
           ``decode.vae``, ``decode.readback``, ``decode.safety``),
           ``graph.capture``, ``graph.replay``, ``kernel.build``
device     ``worker.throttle``, ``worker.wait``
=========  =========================================================
"""

from __future__ import annotations

import collections
import csv
import itertools
import json
import threading
import time
from typing import Dict, List, NamedTuple

MAX_SPANS = 1 << 18

_on = False
_lock = threading.Lock()
_spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
_counters: Dict[str, int] = {}
_dropped = 0
_ids = itertools.count(1)
_tls = threading.local()


class SpanRecord(NamedTuple):
    name: str
    thread: str
    t0_ns: int
    t1_ns: int
    sid: int
    parent: int      # the parent's ``sid``; 0: none
    ids: tuple       # the request ids the span served
    attrs: dict


class _NoSpan:
    """The shared span of a recorder that is off: falsy, so that a caller
    computes attributes only under ``if sp:``."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _NoSpan()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class Span:
    __slots__ = ("name", "reqs", "attrs", "t0", "sid", "parent", "is_phase")

    def __init__(self, name: str, reqs, attrs: dict, is_phase: bool = False):
        self.name, self.reqs, self.attrs = name, reqs, attrs
        self.is_phase = is_phase

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        st = _stack()
        self.parent = st[-1].sid if st else 0
        self.sid = next(_ids)
        st.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        st = _stack()
        # phases left open inside this span end with it
        while st and st[-1] is not self:
            st.pop()._finish(t1)
        if st:
            st.pop()
        self._finish(t1)
        return False

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def _finish(self, t1: int) -> None:
        global _dropped
        ids = (tuple(r.request_id for r in self.reqs) if self.reqs
               else ())
        rec = SpanRecord(self.name, threading.current_thread().name, self.t0,
                         t1, self.sid, self.parent, ids, self.attrs)
        with _lock:
            if len(_spans) == MAX_SPANS:
                _dropped += 1
            _spans.append(rec)


def span(name: str, reqs=None, **attrs):
    """A span of ``name`` over the ``with`` block; ``reqs``, the requests it
    serves (their ``request_id``s are recorded).  Off: :data:`NOOP`."""
    if not _on:
        return NOOP
    return Span(name, reqs, attrs)


def phase(name: str) -> None:
    """End the phase open on this thread, if any, and begin the phase
    ``name`` as a child of the span around it; the span's end ends it.
    Outside any span, or off, nothing."""
    if not _on:
        return
    st = _stack()
    if st and st[-1].is_phase:
        if st[-1].name == name:
            return
        st.pop()._finish(time.perf_counter_ns())
    if st:
        Span(name, None, {}, is_phase=True).__enter__()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` and to the attribute ``name`` of
    the ``stage.*`` span open on this thread.  Off: nothing."""
    if not _on:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
    for s in reversed(_stack()):
        if s.name.startswith("stage."):
            s.attrs[name] = s.attrs.get(name, 0) + n
            break


def stage_set(**attrs) -> None:
    """Set attributes of the ``stage.*`` span open on this thread (callers
    guard the call with :func:`enabled`)."""
    for s in reversed(_stack()):
        if s.name.startswith("stage."):
            s.attrs.update(attrs)
            break


def enable(on: bool) -> None:
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop every span and counter recorded so far."""
    global _dropped
    with _lock:
        _spans.clear()
        _counters.clear()
        _dropped = 0


def spans() -> List[SpanRecord]:
    """The spans recorded, oldest first (a copy)."""
    with _lock:
        return list(_spans)


def counters() -> Dict[str, int]:
    with _lock:
        return {"dropped": _dropped, "recorded": len(_spans),
                **_counters}


def dump(spans_path: str, counters_path: str) -> None:
    """Write ``spans.csv`` (one row a span; request ids joined by ``;``,
    attributes as JSON) and ``counters.json``."""
    records = spans()
    with open(spans_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "thread", "start_ns", "end_ns", "span_id",
                    "parent_id", "request_ids", "attrs"])
        for r in records:
            w.writerow([r.name, r.thread, r.t0_ns, r.t1_ns, r.sid, r.parent,
                        ";".join(map(str, r.ids)),
                        json.dumps(r.attrs, sort_keys=True)])
    with open(counters_path, "w") as f:
        json.dump(counters(), f, indent=1, sort_keys=True)

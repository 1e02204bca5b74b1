"""Step graphs: the card's form of the JAX package's fused chunk programs.

The JAX pipelines run a chunk of k sampler steps (``steps_per_dispatch``)
as one jitted program, a ``fori_loop`` over the per-step bodies
(``self._jit(chunk_key, ...)``).  The port runs the same chunk as k
replays of captured ``torch.cuda.CUDAGraph``s, one graph per *step kind*,
so that one host dispatch issues k steps of device work.

A :class:`StepSet` holds, for one batch shape of one path (dense UNet,
patch path, SD3 tokens; resolution or patch composition; batch bucket;
cache signature), the static buffers its steps read and write, and one
graph per step kind (``"full"``, ``"shallow"``, ``("partial", kb)``,
...).  A step is a function of the set's buffers that writes its results
back into them in place (:func:`store`), so a chunk's steps run in a row
on the same buffers with no copy between them: the host work per step is
a device copy of that step's timestep and coefficient row into the
``"tc"`` buffer and one replay.

* The first time a kind runs, its step runs eagerly (the chunk's real
  step), which also fills every cache a capture must not touch (the patch
  context's rows, the MMDiT's position table, the compact sub-context,
  the ``nvcc`` build, each kernel's shared-memory attribute); then the
  same step is captured.  Later steps of that kind replay.
* Inputs are copied into the buffers (:meth:`StepSet.load`) and results
  are read from them with ``.clone()``: a request never holds a view of a
  buffer, which the next replay rewrites.
* A composition entry's row caches (the hybrid's and compact's rows,
  gigabytes at SDXL 1024^2, bucket 8) are not copied per chunk: the
  entry's rows live in the set's ``"state"`` buffer (:meth:`StepSet.adopt`),
  so the graphs read and write the entry's own tensors.  A set with no
  such buffer takes the entry's tensors as it; a later composition of the
  same shape has its rows copied in once, when it first runs a chunk (its
  rows are a fresh gather then anyway), so a graph captured during
  prewarm serves every later composition of its shape.
* Row-state buffers are row-cache memory like the composition stores':
  the pipeline counts both against ``CacheConfig.comp_state_bytes``
  (:meth:`StepGraphs.row_states`), drops the least recently used set
  whose rows no live entry holds when over it (:meth:`StepGraphs.drop_idle`)
  and drops every row-holding set, graphs included, when it releases its
  serving state (:meth:`StepGraphs.drop_rows`).
* All graphs of a pipeline share one memory pool: replays run one at a
  time on one stream, and every tensor that outlives a step lives outside
  the pool.  Each dp replica has its own pipeline, so its step sets,
  buffers, pool and capture stream are its own, on its device; capture
  and replay run under ``torch.cuda.device(pipeline device)``.
* Launch counters stay truthful: the launches a capture records are taken
  back off the counters and added again at every replay.
* A capture waits for ``before_capture`` (the worker's in-flight
  background decode) and runs with ``capture_error_mode="thread_local"``.
  A capture or replay failure raises.

On the CPU the same steps run eagerly on the same buffers: the device is
the CPU, there is nothing to capture.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import torch

from sduss_tpu_torch import tracing
from sduss_tpu_torch.ops.flash import (flash_cross_short, flash_mha,
                                       flash_mha_fused, flash_mha_masked)
from sduss_tpu_torch.ops.gn_dense import gn_dense
from sduss_tpu_torch.ops.gn_halo import gn_silu_halo
from sduss_tpu_torch.parallel.replica import on_device
from sduss_tpu_torch.parallel.sharding import parts_of

# The wrappers whose ``launches`` counters chip_smoke reads.
COUNTED = (flash_mha_fused, flash_mha, flash_mha_masked, flash_cross_short,
           gn_silu_halo, gn_dense)

# Step sets kept per pipeline, least recently used first out.  A set holds
# its graphs and its buffers (its row state, if any, is bounded by bytes
# apart from this count); serving touches one set per (path, resolution or
# composition, bucket, cache signature), so 64 covers every shape prewarm
# walks (3 resolutions x 5 buckets x 2 paths, plus mixed compositions)
# with room.
MAX_STEP_SETS = 64


def _leaves(tree, path=()):
    """``(path, tensor)`` of a tensor or a nested dict of tensors."""
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))


def _get(tree, path):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            return None
        tree = tree[k]
    return tree


def _set(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


def clone_tree(tree):
    """A copy of a tensor or a dict tree of tensors (new dicts, new
    tensors)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return {k: clone_tree(v) for k, v in tree.items()}


def view_tree(tree):
    """New dicts over the same leaves: a holder may pop or replace its
    keys without touching ``tree``'s dicts."""
    if isinstance(tree, dict):
        return {k: view_tree(v) for k, v in tree.items()}
    return tree


def same_shapes(a, b) -> bool:
    la, lb = list(_leaves(a)), list(_leaves(b))
    return (len(la) == len(lb)
            and all(pa == pb and ta.shape == tb.shape and ta.dtype == tb.dtype
                    for (pa, ta), (pb, tb) in zip(la, lb)))


def unique_nbytes(trees) -> int:
    """Bytes of the tensors of ``trees`` (every shard's part of a sharded
    leaf included), each storage counted once."""
    seen = {(t.device, t.data_ptr()): t.numel() * t.element_size()
            for tree in trees for t in parts_of(tree)}
    return sum(seen.values())


def store(dst, src) -> None:
    """Write a step's result ``src`` into the buffer ``dst`` (tensors or
    matching dict trees); a leaf that already is the buffer stays."""
    for path, d in _leaves(dst):
        s = _get(src, path)
        if s is not d:
            d.copy_(s)


def keep_leaves(tree, fn: Callable):
    """Call ``fn()`` and keep ``tree``'s leaves in place: a leaf the call
    replaced in its dict (the block gate returns new rows) is copied into
    the old tensor, which goes back into the dict; a popped key stays
    popped.  Returns ``fn()``'s result."""
    before = list(_leaves(tree))
    out = fn()
    for path, old in before:
        new = _get(tree, path)
        if new is not None and new is not old:
            old.copy_(new)
            _set(tree, path, old)
    return out


class StepSet:
    """Buffers and per-kind graphs of one batch shape (module docstring)."""

    def __init__(self, graphs: "StepGraphs"):
        self.graphs = graphs
        self.bufs: Dict[str, object] = {}
        self._captured: Dict[object, tuple] = {}
        self._owner = None  # the entry whose row state lives in bufs

    def load(self, name: str, value):
        """Copy ``value`` (a tensor or dict tree) into buffer ``name``; the
        first load, or one of another shape, allocates it."""
        buf = self.bufs.get(name)
        if buf is None or not same_shapes(buf, value):
            if buf is not None:
                self._captured.clear()  # graphs read the old buffer
            self.bufs[name] = clone_tree(value)
        else:
            store(buf, value)
        return self.bufs[name]

    def adopt(self, name: str, entry: dict, live: Callable[[dict], bool]):
        """Make ``entry["state"]`` live in buffer ``name`` (module
        docstring): a missing buffer, or one of other shapes, becomes the
        entry's own tensors; a matching one receives a copy of them.  The
        entry that held the buffer before keeps a copy of its rows when
        ``live(it)`` says it is still in its store."""
        st = entry["state"]
        buf = self.bufs.get(name)
        if buf is not None and all(_get(st, p) is t for p, t in _leaves(buf)):
            # already held; keys a gate popped from the buffer go too
            entry["state"] = view_tree(buf)
            self._owner = entry
            return
        owner = self._owner
        if (owner is not None and owner is not entry and buf is not None
                and live(owner)):
            owner["state"] = clone_tree(owner["state"])
        if buf is None or not same_shapes(buf, st):
            self._captured.clear()  # graphs read the old buffer
            self.bufs[name] = view_tree(st)
        else:
            store(buf, st)
        entry["state"] = view_tree(self.bufs[name])
        self._owner = entry

    def idle_rows(self, live: Callable[[dict], bool]) -> bool:
        """Holds a ``"state"`` buffer that no live entry's rows are in."""
        return "state" in self.bufs and (self._owner is None
                                         or not live(self._owner))

    def run(self, kind, step: Callable[[dict], None]) -> None:
        """One step of ``kind``: ``step(bufs)`` eagerly on the CPU and the
        first time on the card (then captured), a replay afterwards; on
        the card under the pipeline's device."""
        g = self.graphs
        if not g.live:
            step(self.bufs)
            return
        with on_device(g.device):
            self._run_live(kind, step)

    def _run_live(self, kind, step: Callable[[dict], None]) -> None:
        g = self.graphs
        if g.events is not None:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        got = self._captured.get(kind)
        if got is not None:
            graph, delta = got
            with tracing.span("graph.replay"):
                graph.replay()
            for fn, n in zip(COUNTED, delta):
                fn.launches += n
            g.replays += 1
        else:
            step(self.bufs)  # the real step, and the warm-up of its caches
        if g.events is not None:
            end.record()
            g.events.append((kind, start, end))
        if got is None:
            self._captured[kind] = g.capture(lambda: step(self.bufs))


class StepGraphs:
    """A pipeline's step sets, LRU-bounded by :data:`MAX_STEP_SETS`."""

    def __init__(self, device: torch.device):
        self.device = device
        self.live = device.type == "cuda"
        self._sets: "collections.OrderedDict[object, StepSet]" = \
            collections.OrderedDict()
        self._pool = None
        self._stream = None
        # called before each capture (the worker waits for its background
        # decode there)
        self.before_capture: Optional[Callable[[], None]] = None
        self.captures = 0
        self.replays = 0
        # when a caller sets it to a list: (kind, start, end) CUDA events
        # around every step run on the card
        self.events = None

    def held(self) -> int:
        """Graphs held (every set's captured kinds)."""
        return sum(len(s._captured) for s in self._sets.values())

    def step_set(self, key) -> StepSet:
        s = self._sets.get(key)
        if s is None:
            s = self._sets[key] = StepSet(self)
            while len(self._sets) > MAX_STEP_SETS:
                self._sets.popitem(last=False)
        self._sets.move_to_end(key)
        return s

    def buffers(self) -> list:
        """Every set's buffers (tensors and dict trees of tensors)."""
        return [b for st in list(self._sets.values())
                for b in list(st.bufs.values())]

    def row_states(self) -> list:
        """Every set's ``"state"`` buffer: row-cache memory."""
        return [st.bufs["state"] for st in list(self._sets.values())
                if "state" in st.bufs]

    def drop_idle(self, live: Callable[[dict], bool]) -> bool:
        """Drop the least recently used set, never the newest (the one a
        chunk is running or about to run on), whose row state no live
        entry holds (:meth:`StepSet.idle_rows`), with its graphs.  False
        when there is none."""
        for key in list(self._sets)[:-1]:
            if self._sets[key].idle_rows(live):
                del self._sets[key]
                return True
        return False

    def drop_rows(self) -> None:
        """Drop every set holding row state, with its graphs."""
        for key in [k for k, st in self._sets.items() if "state" in st.bufs]:
            del self._sets[key]

    def capture(self, fn: Callable[[], None]) -> tuple:
        """Capture ``fn`` into a graph in the shared pool; returns ``(graph,
        launches it records per counter)``.  Launches made during the
        capture ran nothing, so they come off the counters."""
        if self.before_capture is not None:
            self.before_capture()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            # the pipeline's own capture stream: torch.cuda.graph's default
            # is one stream for the process, made on the device current at
            # the first capture, and a dp replica on another card cannot
            # capture on it
            self._stream = torch.cuda.Stream(device=self.device)
        counts = [f.launches for f in COUNTED]
        graph = torch.cuda.CUDAGraph()
        try:
            with tracing.span("graph.capture"), torch.cuda.graph(
                    graph, pool=self._pool, stream=self._stream,
                    capture_error_mode="thread_local"):
                fn()
        finally:
            delta = tuple(f.launches - n for f, n in zip(COUNTED, counts))
            for f, n in zip(COUNTED, counts):
                f.launches = n
        self.captures += 1
        return graph, delta

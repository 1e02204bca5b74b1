"""In-process SPMD over a replica's devices: the port's counterpart of what
``shard_map`` and XLA's collectives give the JAX package.

A ``ShardGroup`` lays ``sp * tp`` shards out as JAX's ``(sp, tp)`` mesh
(rank ``r = sp_index * tp + tp_index``) and holds one persistent host
thread per shard.  Each thread makes its shard's device current, issues
its work to a CUDA stream of its own and runs under
``torch.inference_mode``.  :meth:`ShardGroup.run` runs ``fn(rank)`` on
every shard and returns the results in rank order; inside ``fn`` the
collectives act over one mesh axis:

  axis_index / axis_size   the shard's coordinate and the axis's length
  all_gather(x, axis, dim) the axis's shards' ``x`` concatenated on ``dim``
  psum(x, axis)            their sum, added in axis order on every shard,
                           so that every shard's result is bitwise equal
  ppermute(x, axis, perm)  ``x`` from the shard that sends to this one
                           (``perm``: ``(source, destination)`` axis
                           indices), zeros where nothing arrives, as
                           ``lax.ppermute`` gives

A collective takes a tensor or a tuple of tensors (one rendezvous for the
tuple).  The shard threads take turns on the host: a turn passes from
rank to rank at each collective, so that one thread issues work at a time
(two threads issuing PyTorch ops at once hand the GIL back and forth at
every op, which costs more than the ops), while each shard's kernels run
on its own stream, concurrently on the card.  A shard deposits its
tensors and passes the turn; when its turn comes back, every shard has
deposited, and it reads the peers' tensors: on the card its stream waits
for the event the writer recorded after producing them, then reads them
in place (same card) or copies them (``Tensor.to(device,
non_blocking=True)``, another card), and it keeps each peer tensor alive
until the event it records after the read has completed.  The deposits
alternate between two slot tables by the parity of the collective's
sequence number: a slot is written again only after every shard has
passed the next collective, and so read this one.  Each deposit carries
its sequence number: a shard that finds a peer's deposit from another
collective, or a peer that has returned from ``fn``, raises (the shards'
collectives differ), instead of reading a stale tensor.

Devices may repeat: ``sp=2`` on ``[cuda:0, cuda:0]`` runs both shards on
one card, on two streams.  On the CPU every shard is ``cpu`` and the
collectives are plain tensor ops.

If any shard raises, the others leave their wait for a turn at once
(``BrokenBarrierError``) and :meth:`run` re-raises the first real error in
the caller; a wait longer than ``timeout`` seconds breaks the same way (a
turn lasts milliseconds of host time; the first forward on a card may
build the kernels, about 15 s on an H100 host).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import Callable, List, Optional, Sequence

import torch

from .mesh import make_mesh

AXES = ("sp", "tp")


class ShardGroup:
    """``devices``: ``sp * tp`` devices (repeats allowed), rank order."""

    def __init__(self, devices: Sequence, sp: int = 1, tp: int = 1,
                 timeout: float = 60.0):
        devices = [torch.device(d) for d in devices]
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if d.type == "cuda" and d.index is None else d
                   for d in devices]
        if len(devices) != sp * tp:
            raise ValueError(f"a group of sp={sp} x tp={tp} needs "
                             f"{sp * tp} devices, got {len(devices)}")
        if sp < 1 or tp < 1:
            raise ValueError(f"sp and tp must be >= 1, got {sp}, {tp}")
        self.devices = devices
        self.mesh = make_mesh(sp=sp, tp=tp, devices=devices)
        # read at every collective: worked out once
        self._coords = [self.mesh.coords(r) for r in range(sp * tp)]
        self._lines = {(r, a): self.mesh.line(r, a)
                       for r in range(sp * tp) for a in AXES}
        self.sp, self.tp = sp, tp
        self.size = sp * tp
        self.timeout = timeout
        # a turn is a token: rank r's semaphore is released to hand it to
        # r, so that passing it wakes that thread alone
        self._turns = [threading.Semaphore(0) for _ in range(self.size)]
        self._failed: Optional[BaseException] = None
        self._slots = [[None] * self.size, [None] * self.size]
        self._seq = [0] * self.size
        self._done = [False] * self.size
        self._holds: List[list] = [[] for _ in range(self.size)]
        self._local = threading.local()
        self._streams = [None] * self.size
        self._pools = [concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix=f"shard-{r}",
            initializer=self._init_thread, initargs=(r,))
            for r in range(self.size)]
        self._broken = None  # the reason a run left the group unusable

    # -- threads -------------------------------------------------------------

    def _init_thread(self, rank: int) -> None:
        self._local.rank = rank
        dev = self.devices[rank]
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            self._streams[rank] = torch.cuda.Stream(device=dev)

    def close(self) -> None:
        """Stop the shard threads."""
        for pool in self._pools:
            pool.shutdown(wait=True)

    def rank(self) -> Optional[int]:
        """The calling shard thread's rank; None off the shard threads."""
        return getattr(self._local, "rank", None)

    def device(self, rank: Optional[int] = None) -> torch.device:
        return self.devices[self.rank() if rank is None else rank]

    # -- mesh coordinates ----------------------------------------------------

    def coords(self, rank: int) -> tuple:
        """``(sp_index, tp_index)`` of ``rank`` on the group's mesh."""
        at = self._coords[rank]
        return at["sp"], at["tp"]

    def axis_size(self, axis: str) -> int:
        return {"sp": self.sp, "tp": self.tp}[axis]

    def axis_index(self, axis: str, rank: Optional[int] = None) -> int:
        i, j = self.coords(self.rank() if rank is None else rank)
        return {"sp": i, "tp": j}[axis]

    def peers(self, axis: str, rank: Optional[int] = None) -> List[int]:
        """Ranks of ``rank``'s axis group, in axis order."""
        if axis not in AXES:
            raise ValueError(f"unknown axis {axis!r}; axes are {AXES}")
        return self._lines[self.rank() if rank is None else rank, axis]

    def lead_ranks(self) -> List[int]:
        """One rank per sp row, tp index 0, in sp order: the shards whose
        outputs the caller gathers."""
        return self._lines[0, "sp"]

    # -- run -----------------------------------------------------------------

    def run(self, fn: Callable[[int], object]) -> list:
        """``fn(rank)`` on every shard thread; the results in rank order.

        On the card each shard's stream first waits for the caller's
        current stream (the inputs the caller made), and the caller's
        stream waits for every shard's stream at the end (the outputs)."""
        if self._broken is not None:
            raise RuntimeError(f"shard group unusable: {self._broken}")
        start = None
        if any(d.type == "cuda" for d in self.devices):
            start = torch.cuda.Event()
            start.record()
        self._seq = [0] * self.size
        self._done = [False] * self.size
        self._failed = None
        self._turns = [threading.Semaphore(0) for _ in range(self.size)]
        self._turns[0].release()
        futures = [pool.submit(self._shard_call, r, fn, start)
                   for r, pool in enumerate(self._pools)]
        results, errors = [None] * self.size, []
        deadline = time.monotonic() + 2 * self.timeout
        for r, fut in enumerate(futures):
            try:
                results[r], end = fut.result(
                    timeout=max(deadline - time.monotonic(), 0.0))
            except concurrent.futures.TimeoutError as e:
                self._broken = f"shard {r} did not return in time"
                self._abort(TimeoutError(self._broken))
                raise TimeoutError(self._broken) from e
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                continue
            if end is not None:
                torch.cuda.current_stream().wait_event(end)
        self._slots = [[None] * self.size, [None] * self.size]
        if errors:
            real = [e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)]
            raise (real or errors)[0]
        return results

    def _shard_call(self, rank: int, fn, start):
        stream = self._streams[rank]
        try:
            self._wait_turn(rank)
            if stream is None:
                with torch.inference_mode():
                    out, end = fn(rank), None
            else:
                stream.wait_event(start)
                self._prune(rank)
                with torch.cuda.stream(stream), torch.inference_mode():
                    out = fn(rank)
                end = torch.cuda.Event()
                end.record(stream)
            self._done[rank] = True
            self._pass_turn(rank)
            return out, end
        except BaseException as e:
            self._abort(e)
            raise

    # -- turns ---------------------------------------------------------------

    def _wait_turn(self, rank: int) -> None:
        """Block until it is ``rank``'s turn; raise if a shard failed or
        the wait outlasts ``timeout``."""
        ok = self._turns[rank].acquire(timeout=self.timeout)
        if self._failed is not None:
            raise threading.BrokenBarrierError(
                f"shard {rank}: another shard failed ({self._failed!r})")
        if not ok:
            err = TimeoutError(f"shard {rank} waited {self.timeout} s for "
                               f"its turn")
            self._abort(err)
            raise err

    def _pass_turn(self, rank: int) -> None:
        self._turns[(rank + 1) % self.size].release()

    def _abort(self, err: BaseException) -> None:
        """Fail the run: every waiting shard wakes and raises."""
        if self._failed is None:
            self._failed = err
        for sem in self._turns:
            sem.release()

    # -- collectives ---------------------------------------------------------

    def _prune(self, rank: int) -> None:
        """Release the peer tensors whose reads have completed: the holds
        are in stream order, so from the oldest to the first pending."""
        holds = self._holds[rank]
        done = 0
        while done < len(holds) and holds[done][0].query():
            done += 1
        del holds[:done]

    def _exchange(self, xs: tuple) -> list:
        """Deposit this shard's tensors, pass the turn, and take it back
        once every shard has deposited: returns the slot table (one
        ``(seq, tensors, event)`` per rank)."""
        rank = self.rank()
        if rank is None:
            raise RuntimeError("a collective runs only inside ShardGroup.run")
        seq = self._seq[rank]
        self._seq[rank] = seq + 1
        self._check_peers(rank, seq, None)
        ev = None
        if xs[0].is_cuda:
            ev = torch.cuda.Event()
            ev.record()
        slots = self._slots[seq % 2]
        slots[rank] = (seq, xs, ev)
        self._pass_turn(rank)
        self._wait_turn(rank)
        self._check_peers(rank, seq, slots)
        return slots

    def _check_peers(self, rank: int, seq: int, slots) -> None:
        """Raise unless every shard is at collective ``seq``: before the
        deposit (``slots`` None), none has returned from ``fn``; after
        the turn came back, each has deposited for this one (a shard that
        has read the last collective may have returned by then)."""
        done = [] if slots is not None else [
            p for p in range(self.size) if self._done[p]]
        off = [] if slots is None else [
            p for p in range(self.size)
            if slots[p] is None or slots[p][0] != seq]
        if done or off:
            raise RuntimeError(
                f"shard {rank} is at collective #{seq} while shards {done} "
                f"returned from fn and shards {off} are at another: the "
                f"shards' collectives differ")

    def _fetch(self, entry, i: int, used: list):
        """Peer tensor ``i`` of a slot entry, readable on this shard's
        stream and device: the same tensor on the same device, a copy
        from another."""
        _, xs, ev = entry
        x = xs[i]
        if ev is None:
            return x
        stream = torch.cuda.current_stream()
        stream.wait_event(ev)
        used.append(x)
        me = self.device()
        return x if x.device == me else x.to(me, non_blocking=True)

    def _held(self, used: list) -> None:
        """Keep the peer tensors ``used`` until this stream has read
        them."""
        if used:
            ev = torch.cuda.Event()
            ev.record()
            self._holds[self.rank()].append((ev, used))
            self._prune(self.rank())

    @staticmethod
    def _as_tuple(x):
        return (x, False) if isinstance(x, tuple) else ((x,), True)

    def all_gather(self, x, axis: str, dim: int):
        """The axis group's ``x`` concatenated along ``dim``, in axis order
        (``lax.all_gather(..., tiled=True)``)."""
        xs, single = self._as_tuple(x)
        slots = self._exchange(xs)
        used: list = []
        out = tuple(torch.cat([self._fetch(slots[p], i, used)
                               for p in self.peers(axis)], dim=dim)
                    for i in range(len(xs)))
        self._held(used)
        return out[0] if single else out

    def psum(self, x, axis: str):
        """The axis group's sum of ``x``, in float32, added in axis order
        and cast back: bitwise the same on every shard."""
        xs, single = self._as_tuple(x)
        slots = self._exchange(xs)
        used: list = []
        out = []
        for i, t in enumerate(xs):
            acc = None
            for p in self.peers(axis):
                v = self._fetch(slots[p], i, used).float()
                acc = v if acc is None else acc + v
            out.append(acc.to(t.dtype))
        self._held(used)
        return out[0] if single else tuple(out)

    def ppermute(self, x, axis: str, perm):
        """``x`` of the axis shard that ``perm`` sends to this one, as a new
        tensor; zeros when none does.  With a tuple of tensors ``perm`` may
        be a tuple of perms, one a tensor (one rendezvous for all)."""
        xs, single = self._as_tuple(x)
        perms = perm if isinstance(perm, tuple) else (perm,) * len(xs)
        slots = self._exchange(xs)
        me = self.axis_index(axis)
        peers = self.peers(axis)
        used: list = []
        out = []
        for i, t in enumerate(xs):
            src = [s for s, d in perms[i] if d == me]
            if not src:
                out.append(torch.zeros_like(t))
                continue
            entry = slots[peers[src[0]]]
            got = self._fetch(entry, i, used)
            # a new tensor: the peer's own on this device is cloned
            out.append(got.clone() if got is entry[1][i] else got)
        self._held(used)
        return out[0] if single else tuple(out)

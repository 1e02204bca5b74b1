"""The traced run: the device's kernels over the window, from
``torch.profiler`` (CUDA activity only, so the host records no op of its
own), reduced in memory; nothing is written to disk.

- ``busy_s``: the union of kernel spans inside the window (the rule of
  ``chip_smoke.py busy_shares``, copied here);
- device time by op class (``scripts/profile_torch_step.py OP_CLASSES``,
  copied here; first match wins) and by kernel name, for ``breakdown``;
- the longest idle gaps, each named by what the host was doing when it
  began (the probe's spans: prepare, a denoise step, a decode, or the
  engine loop between them);
- the attention kernels' device time, for ``attn_roofline``.

Kernel timestamps are the profiler's nanoseconds; the host spans are
converted to them by one offset, measured when tracing starts by a marker
kernel (``torch.cuda._sleep``'s ``spin_kernel``) launched on a stream of
its own at a known host time.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

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
# the kernels that run attention: the port's flash template (K1, K2/K3
# masked and unmasked), K5, and PyTorch's own attention kernels should a
# route ever take them
ATTENTION_KEYS = ("mha_fused", "cross_short", "flash_fwd", "fmha",
                  "attention_kernel", "efficient_attention")


def op_class(name: str) -> str:
    low = name.lower()
    for cls, keys in OP_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def is_attention(name: str) -> bool:
    low = name.lower()
    return any(k in low for k in ATTENTION_KEYS)


class Tracer:
    """Profiles the device between :meth:`start` and :meth:`stop`."""

    def __init__(self, device_type: str = "cuda"):
        self.prof = None
        self.offset_ns = 0.0  # epoch ns minus perf_counter ns
        # the CPU's ops stand in for kernels only in the CPU tests
        self.cuda = device_type == "cuda"

    def start(self) -> None:
        act = torch.profiler.ProfilerActivity
        self.prof = torch.profiler.profile(
            activities=[act.CUDA if self.cuda else act.CPU])
        self.prof.__enter__()
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._marker_ns = None
        if self.cuda:
            with torch.cuda.stream(torch.cuda.Stream()):
                self._marker_ns = time.perf_counter_ns()
                torch.cuda._sleep(1000)

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)

    def kernels(self) -> List[tuple]:
        """``(name, start_ns, end_ns)`` of every device op."""
        out = []
        want = (torch.autograd.DeviceType.CUDA if self.cuda
                else torch.autograd.DeviceType.CPU)
        marker = None
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == want:
                s = e.start_ns()
                if self._marker_ns is not None and marker is None \
                        and "spin_kernel" in e.name():
                    marker = s
                    continue
                out.append((e.name(), s, s + e.duration_ns()))
        self.aligned = marker is not None
        if marker is not None:
            self.offset_ns = marker - self._marker_ns
        return out


def reduce(kernels: List[tuple], w0_ns: float, w1_ns: float,
           spans: List[tuple], active: List[tuple] = ()) -> dict:
    """The window's device numbers; ``spans`` are the probe's host spans
    ``(kind, t0_ns, t1_ns)`` and ``active`` each request's time in the
    system ``(sent, returned)``, both on the profiler's clock."""
    ks = sorted((max(s, w0_ns), min(e, w1_ns), n) for n, s, e in kernels
                if e > w0_ns and s < w1_ns)
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    prev_end = w0_ns
    by_class: Dict[str, float] = {}
    by_name: Dict[str, float] = {}
    attn_s = 0.0
    for s, e, name in ks:
        d = (e - s) / 1e9
        by_class[op_class(name)] = by_class.get(op_class(name), 0.0) + d
        short = name.split("(")[0][:120]
        by_name[short] = by_name.get(short, 0.0) + d
        if is_attention(name):
            attn_s += d
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > prev_end:
                gaps.append((prev_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        prev_end = max(prev_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if w1_ns > prev_end:
        gaps.append((prev_end, w1_ns))
    gaps.sort(key=lambda g: g[0] - g[1])
    named = [[host_doing(spans, active, a), (b - a) / 1e9]
             for a, b in gaps[:10]]
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e9, "window_s": (w1_ns - w0_ns) / 1e9,
            "attn_device_s": attn_s, "by_class": by_class,
            "device_ops": [[n, v] for n, v in device_ops],
            "idle_gaps": named, "n_kernels": len(ks)}


def host_doing(spans: List[tuple], active, t_ns: float) -> str:
    """The probe span covering ``t_ns`` (the latest started), the engine
    loop between stages, or, with no request in the system, the wait for
    arrivals."""
    if active and not any(a <= t_ns < b for a, b in active):
        return "no request in the system (arrivals)"
    best: Optional[tuple] = None
    for kind, a, b in spans:
        if a <= t_ns <= b and (best is None or a > best[1]):
            best = (kind, a)
    return best[0] if best else "engine loop between stages"

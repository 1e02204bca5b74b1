"""Kernels (``ops/flash.py``, ``ops/gn_halo.py``, ``csrc/*.cu``): the least
time the window's attention work could take on the card (each call's
operations at the bf16 peak or its bytes at the memory rate, whichever is
longer; real images only) over the device time of the kernels that ran
attention in the trace, in %."""


def read(run):
    if run.work is None or run.trace is None:
        return None
    dev = run.trace["attn_device_s"]
    if dev <= 0 or run.work["attn_bound_s"] <= 0:
        return None
    return run.work["attn_bound_s"] / dev * 100.0

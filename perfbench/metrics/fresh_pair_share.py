"""Pipelines (the hybrid's CFG-pair gates, ``cache/manager.py``): of the
real CFG pairs the gates scored in the window's denoise steps, the share
they recomputed, from the counts on the program's ``stage.denoise`` spans
ending in the window (``lib/host_idle.py``), in %."""

from perfbench.lib import host_idle


def read(run):
    return host_idle.fresh_pair_share(run)

"""Scheduler (``scheduler/``, ``engine/worker.py``): the share of the
traced window in which the card was idle while the engine thread was in
``worker.schedule`` or ``worker.advance`` (``lib/host_idle.py``), in
%."""

from perfbench.lib import host_idle


def read(run):
    return host_idle.idle_share(run, "sched")

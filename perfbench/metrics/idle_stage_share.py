"""Pipelines (``pipelines/``, ``cache/manager.py``): the share of the
traced window in which the card was idle while the engine thread was in a
``stage.*`` span or one of its children, enqueueing more slowly than the
card drained (``lib/host_idle.py``), in %."""

from perfbench.lib import host_idle


def read(run):
    return host_idle.idle_share(run, "stage")

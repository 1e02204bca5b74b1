"""Pipelines (the deep cache, ``pipelines/base.py``): of the window's
request-steps with a deep mode, the share whose deep feature was
recomputed (mode ``full``, and the refreshed rows of ``partial`` steps),
from the counts on the program's ``stage.denoise`` spans ending in the
window (``lib/host_idle.py``), in %."""

from perfbench.lib import host_idle


def read(run):
    return host_idle.full_step_share(run)

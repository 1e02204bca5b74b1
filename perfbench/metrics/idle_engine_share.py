"""Engine (``engine/engine.py``, ``async_engine.py``): the share of the
traced window in which the card was idle while the engine thread was in
no span (the hand-off through the event loop) or in the self time of
``engine.step``, ``engine.add`` or ``engine.abort``
(``lib/host_idle.py``), in %."""

from perfbench.lib import host_idle


def read(run):
    return host_idle.idle_share(run, "engine")

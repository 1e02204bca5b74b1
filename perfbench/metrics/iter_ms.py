"""Pipelines (``pipelines/base.py``, ``sdxl.py``, ``sd.py``, ``graphs.py``,
``cache/manager.py``): the wall time of the window's DENOISING iterations
(each from its start in the ``schedule_log`` to the next iteration's
start) over how many there were, in ms."""

from perfbench.lib.window import denoise_iterations


def read(run):
    its = denoise_iterations(run.served)
    if not its:
        return None
    return sum(d for _, d, _ in its) / len(its) * 1e3

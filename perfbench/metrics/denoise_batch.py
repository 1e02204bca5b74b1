"""Scheduler (``scheduler/esymred.py``): the mean number of requests in a
DENOISING iteration of the window, from the worker's ``schedule_log``
(``engine.collect_data``, on in the traced run only)."""

from perfbench.lib.window import denoise_iterations


def read(run):
    its = denoise_iterations(run.served)
    if not its:
        return None
    return sum(n for _, _, n in its) / len(its)

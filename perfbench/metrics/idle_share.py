"""Device (one H100): the share of the traced window in which no kernel
ran (1 minus the union of kernel spans, the rule of
``chip_smoke.py busy_shares``), in %."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return (1.0 - run.trace["busy_s"] / run.trace["window_s"]) * 100.0

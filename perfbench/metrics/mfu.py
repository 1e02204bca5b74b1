"""Model step (``models/unet.py``, ``clip.py``, ``vae.py``,
``ops/patch_ctx.py``): the operations the window's work needed (each
request's denoising steps by their mode and recomputed pairs, its decode
and its text encoding: ``perfbench/lib/account.py``) over the window's
seconds times the H100's bf16 peak, in %."""

from perfbench.work.parts import PEAK_FLOPS


def read(run):
    if run.work is None or run.work["flops"] <= 0:
        return None
    return run.work["flops"] / ((run.served.w1 - run.served.w0)
                                * PEAK_FLOPS) * 100.0

"""sduss_tpu_torch — the PyTorch/CUDA port of sduss_tpu for NVIDIA Hopper.

The package mirrors ``sduss_tpu``'s layout module for module, so each
port has an obvious counterpart.  It imports torch and numpy and never jax
nor ``sduss_tpu``: the host modules it needs (config, request, scheduler,
metrics, logger) are copies of the JAX package's.

Public seams keep the JAX package's layouts so the two packages compare
like with like: latents are NHWC ``(B, H, W, C)``, attention inputs and
outputs are ``(B, L, D)`` with head ``h`` at columns ``[h*hd, (h+1)*hd)``.
Inside the modules convolutions run NCHW, the torch idiom.
"""

from __future__ import annotations

import torch


def configure_numerics() -> None:
    """Set the float32 matmul/conv precision of CUDA math, in one place.

    TF32 is OFF for both cuBLAS matmuls and cuDNN convolutions, so a
    float32 VAE decode (``vae_dtype="float32"``) and the float32 safety
    checker are true float32 (TF32 keeps ~3 decimal digits; cuDNN
    convolutions default to it).  bf16 work (the UNet, the text encoders
    and the hand-written attention kernel) is unaffected.  Turning TF32 on
    for speed is a later, measured change.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

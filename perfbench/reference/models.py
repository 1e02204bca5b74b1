"""The reference models of a configuration file, by component name (the
diffusers pipeline's: ``unet``, ``text_encoder``, ``text_encoder_2``,
``vae``)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from perfbench.reference.clip import TextModel
from perfbench.reference.unet import UNet
from perfbench.reference.vae import VAE

TEXT_ENCODERS = ("text_encoder", "text_encoder_2")


def build(cfg: dict, device="meta") -> Dict[str, nn.Module]:
    """Uninitialised modules (on the meta device by default)."""
    with torch.device(device):
        out = {"unet": UNet(cfg["unet"]), "vae": VAE(cfg["vae"])}
        for name in TEXT_ENCODERS:
            if name in cfg:
                out[name] = TextModel(cfg[name])
    return out


def param_kind(name: str) -> str:
    """How a parameter is drawn: ``"w"`` (a linear or conv weight, normal
    at std 1/sqrt(fan-in)), ``"emb"`` (an embedding table, standard
    normal), ``"one"`` (a norm's scale) or ``"zero"`` (a bias or a norm's
    shift)."""
    leaf = name.rsplit(".", 1)[-1]
    if "embedding" in name and name.endswith("embedding.weight"):
        return "emb"
    if "norm" in name.rsplit(".", 2)[-2]:
        return "one" if leaf == "weight" else "zero"
    if leaf == "bias":
        return "zero"
    return "w"


def load(modules: Dict[str, nn.Module],
         tensors: Dict[str, Dict[str, torch.Tensor]],
         device) -> Dict[str, nn.Module]:
    """Float32 copies of ``tensors`` (component -> key -> tensor) as the
    modules' parameters, on ``device``."""
    for comp, m in modules.items():
        sd = {k: v.to(device=device, dtype=torch.float32)
              for k, v in tensors[comp].items()}
        m.load_state_dict(sd, strict=True, assign=True)
        m.requires_grad_(False)
    return modules

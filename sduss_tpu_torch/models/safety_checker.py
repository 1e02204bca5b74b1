"""Stable Diffusion safety checker (counterpart of
sduss_tpu/models/safety_checker.py).

Image embeddings from a CLIP vision tower are scored by cosine similarity
against 17 NSFW "concept" embeddings and 3 "special care" ones, each with
its threshold; a special-care match lowers the concept thresholds by 0.01,
and a flagged image is blacked out.  It runs in float32, as in JAX.

``ModelConfig.safety_checker_path`` selects it: a diffusers
``safety_checker/`` component directory, or "random" for seeded random
weights (whose flags mean nothing; for tests and smoke runs).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from sduss_tpu_torch.models.clip_vision import (CLIP_VIT_L14,
                                                TINY_CLIP_VISION,
                                                CLIPVisionModel)
from sduss_tpu_torch.models.loader import _load_safetensors_dir
from sduss_tpu_torch.models.registry import fan_in_init, select_state_dict

_CONCEPTS = ("concept_embeds", "special_care_embeds",
             "concept_embeds_weights", "special_care_embeds_weights")


class SafetyChecker:
    N_CONCEPTS = 17
    N_SPECIAL = 3

    def __init__(self, tiny: bool = False,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' "
                               "explicitly to run on the CPU")
        with torch.device("meta"):
            self.vision = CLIPVisionModel(
                TINY_CLIP_VISION if tiny else CLIP_VIT_L14)
        self.concepts = None  # the four tensors of _CONCEPTS, once loaded

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> None:
        """Seeded random weights, drawn on the CPU and moved to the device,
        so they are the same on every device: fan-in uniform kernels,
        N(0, 0.02) embeddings, N(0, 1) concept embeddings and thresholds
        of 0.5, as the JAX checker's."""
        gen = torch.Generator().manual_seed(seed)
        self.vision = self.vision.to_empty(device="cpu")
        self.vision.init_random_(gen)
        self.vision = self.vision.to(self.device).eval()
        d = self.vision.cfg.projection_dim
        concepts = {
            "concept_embeds": torch.randn(self.N_CONCEPTS, d, generator=gen),
            "special_care_embeds": torch.randn(self.N_SPECIAL, d,
                                               generator=gen),
            "concept_embeds_weights": torch.full((self.N_CONCEPTS,), 0.5),
            "special_care_embeds_weights": torch.full((self.N_SPECIAL,), 0.5),
        }
        self.concepts = {k: v.to(self.device) for k, v in concepts.items()}

    @torch.no_grad()
    def load(self, component_dir: str) -> None:
        """Load a ``safety_checker/`` component.  The stock
        ``StableDiffusionSafetyChecker`` wraps a ``CLIPVisionModel``, so its
        tower's tensors are named ``vision_model.vision_model.*``; a
        ``CLIPVisionModelWithProjection`` layout (``vision_model.*``, what
        the JAX converter reads) loads too."""
        sd = _load_safetensors_dir(component_dir)
        nested = "vision_model.vision_model."
        if any(k.startswith(nested) for k in sd):
            sd = {k[len("vision_model."):] if k.startswith(nested) else k: v
                  for k, v in sd.items()}
        self.vision = self.vision.to_empty(device=self.device).eval()
        self.vision.load_state_dict(select_state_dict(
            "safety_checker", self.vision.state_dict(), sd, torch.float32),
            strict=True)
        self.concepts = {k: t.to(self.device) for k, t in select_state_dict(
            "safety_checker", _CONCEPTS, sd, torch.float32).items()}

    @torch.inference_mode()
    def image_embeds(self, images: np.ndarray) -> torch.Tensor:
        """(B, H, W, 3) uint8 -> (B, projection_dim) float32 embeddings."""
        px = self.vision.preprocess(torch.from_numpy(np.asarray(images))
                                    .to(self.device))
        return self.vision(px)["image_embeds"]

    @staticmethod
    def _cos(a, b):
        a = a / (torch.linalg.norm(a, dim=-1, keepdim=True) + 1e-8)
        b = b / (torch.linalg.norm(b, dim=-1, keepdim=True) + 1e-8)
        return a @ b.T

    @torch.inference_mode()
    def scores(self, images: np.ndarray) -> torch.Tensor:
        """(B, 17) concept scores; an image is flagged where one is > 0."""
        if self.concepts is None:
            raise RuntimeError("the safety checker has no weights")
        c = self.concepts
        emb = self.image_embeds(images)
        special = self._cos(emb, c["special_care_embeds"]) \
            - c["special_care_embeds_weights"][None]
        has_special = (special > 0).any(dim=-1, keepdim=True)
        adjustment = torch.where(has_special, 0.01, 0.0)
        return self._cos(emb, c["concept_embeds"]) \
            - c["concept_embeds_weights"][None] + adjustment

    def check(self, images: np.ndarray) -> Tuple[np.ndarray, List[bool]]:
        """(B, H, W, 3) uint8 -> (images with flagged ones zeroed, flags)."""
        nsfw = (self.scores(images) > 0).any(dim=-1).cpu().numpy()
        out = np.array(images, copy=True)
        out[nsfw] = 0
        return out, [bool(f) for f in nsfw]


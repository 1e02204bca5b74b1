"""CLIP score: cosine similarity between prompt and generated image
(counterpart of sduss_tpu/evaluation/clip_score.py).

score = 100 * max(0, cos(text_embeds, image_embeds)), the torchmetrics
CLIPScore definition the reference's evaluation template targets.  With a
CLIP snapshot (the openai/clip-vit-large-patch14 layout: safetensors and
tokenizer files in one directory) the real weights load through the
port's loader; without one, seeded random weights still run the whole
path (for tests, not for quality numbers).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from sduss_tpu_torch.models import clip as clip_mod
from sduss_tpu_torch.models import clip_vision as cv
from sduss_tpu_torch.models.loader import _load_safetensors_dir, _load_tokenizer
from sduss_tpu_torch.models.registry import (StubTokenizer, fan_in_init,
                                             select_state_dict)


class ClipScorer:
    """CLIP-L text and vision towers with projections, in float32."""

    def __init__(self, snapshot: Optional[str] = None, tiny: bool = False,
                 seed: int = 0, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' "
                               "explicitly to run on the CPU")
        with torch.device("meta"):
            if tiny:
                self.text = clip_mod.CLIPTextModel(dataclasses.replace(
                    clip_mod.TINY_CLIP, projection_dim=64))
                self.vision = cv.CLIPVisionModel(cv.TINY_CLIP_VISION)
            else:
                self.text = clip_mod.CLIPTextModel(clip_mod.CLIP_L_PROJ)
                self.vision = cv.CLIPVisionModel(cv.CLIP_VIT_L14)
        if snapshot is not None:
            self._load(snapshot)
        else:
            self._init_random(seed)
            self.tokenizer = StubTokenizer(self.text.cfg.vocab_size)

    @torch.no_grad()
    def _init_random(self, seed: int) -> None:
        """Seeded random weights drawn on the CPU, the same on every
        device (``fan_in_init``)."""
        gen = torch.Generator().manual_seed(seed)
        fan_in_init(self.text.to_empty(device="cpu"), gen)
        self.vision.to_empty(device="cpu").init_random_(gen)
        self.text = self.text.to(self.device).eval()
        self.vision = self.vision.to(self.device).eval()

    @torch.no_grad()
    def _load(self, snapshot: str) -> None:
        sd = _load_safetensors_dir(snapshot)
        for name in ("text", "vision"):
            m = getattr(self, name).to_empty(device=self.device).eval()
            m.load_state_dict(select_state_dict(
                f"clip {name}", m.state_dict(), sd, torch.float32),
                strict=True)
        # a CLIP snapshot keeps its tokenizer files at the top level
        self.tokenizer = _load_tokenizer(snapshot, ".",
                                         self.text.cfg.vocab_size)

    @torch.inference_mode()
    def text_embeds(self, prompts: Sequence[str]) -> np.ndarray:
        ids = torch.from_numpy(np.asarray(self.tokenizer(
            list(prompts), max_length=77, padding="max_length",
            truncation=True)["input_ids"], np.int64))
        return self.text(ids.to(self.device))["pooled"].cpu().numpy()

    @torch.inference_mode()
    def image_embeds(self, images: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 -> (B, projection_dim) float32."""
        px = self.vision.preprocess(torch.from_numpy(np.asarray(images))
                                    .to(self.device))
        return self.vision(px)["image_embeds"].cpu().numpy()

    def score(self, prompts: Sequence[str],
              images: Sequence[np.ndarray]) -> List[float]:
        """Per-pair CLIP scores of (prompt, (H, W, 3) uint8 image) pairs."""
        te = self.text_embeds(prompts)
        ie = self.image_embeds(np.stack(images))
        te = te / (np.linalg.norm(te, axis=-1, keepdims=True) + 1e-8)
        ie = ie / (np.linalg.norm(ie, axis=-1, keepdims=True) + 1e-8)
        cos = (te * ie).sum(-1)
        return [float(100.0 * max(0.0, c)) for c in cos]


def clip_score(prompts: Sequence[str], images: Sequence[np.ndarray],
               snapshot: Optional[str] = None,
               device: torch.device | str = "cuda") -> float:
    """Mean CLIP score over the batch (the reference's reported metric)."""
    return float(np.mean(ClipScorer(snapshot=snapshot, device=device)
                         .score(prompts, images)))

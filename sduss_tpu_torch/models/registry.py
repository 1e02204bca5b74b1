"""Model-family registry, weight loading and random init (counterpart of
sduss_tpu/models/registry.py, loader.py and utils.random_params).

A ``ModelBundle`` holds one family's ``nn.Module``s on one device, in one
serving dtype (the VAE in the dtype ``ModelConfig.vae_dtype`` asks for,
by the JAX ``_vae_dtype`` rule), and its tokenizers.  Every component
stays on the device: the JAX
package's ``encoders_on_host`` is a memory policy for a 16 GB TPU chip,
and the full SD3 bundle (~16 GB bf16, T5-XXL ~9.5 GB of it) fits an 80 GB
card next to its activations.  Weights
come from :meth:`ModelBundle.init_random` (seeded, generated on the device)
or :meth:`ModelBundle.load_state_dicts` (diffusers-named tensors: a
snapshot's, through ``models/loader.py``, or the JAX package's parameters
through ``models/convert.py``).
"""

from __future__ import annotations

import copy
import dataclasses
import itertools
import math
import zlib
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from sduss_tpu_torch.models import clip as clip_mod
from sduss_tpu_torch.models import mmdit as mmdit_mod
from sduss_tpu_torch.models import t5 as t5_mod
from sduss_tpu_torch.models import unet as unet_mod
from sduss_tpu_torch.models import vae as vae_mod


@dataclasses.dataclass(frozen=True)
class FamilySpec:
    family: str
    latent_channels: int
    vae_scale: int  # pixels per latent cell
    default_sampler: str
    sampler_kwargs: dict
    default_steps: int
    default_guidance: float
    resolutions: Tuple[int, ...]
    # text encoder roles, in order
    text_encoders: Tuple[str, ...]


SPECS: Dict[str, FamilySpec] = {
    "sd15": FamilySpec(
        family="sd15", latent_channels=4, vae_scale=8,
        default_sampler="euler", sampler_kwargs={}, default_steps=50,
        default_guidance=7.5, resolutions=(256, 512, 768),
        text_encoders=("clip_l",),
    ),
    "sdxl": FamilySpec(
        family="sdxl", latent_channels=4, vae_scale=8,
        default_sampler="euler", sampler_kwargs={}, default_steps=50,
        default_guidance=5.0, resolutions=(512, 768, 1024),
        text_encoders=("clip_l", "clip_g"),
    ),
    "sd3": FamilySpec(
        family="sd3", latent_channels=16, vae_scale=8,
        default_sampler="flow_match", sampler_kwargs={"shift": 3.0},
        default_steps=40, default_guidance=4.5, resolutions=(512, 768, 1024),
        text_encoders=("clip_l", "clip_g", "t5"),
    ),
}


class StubTokenizer:
    """Deterministic hash tokenizer for weight-less runs (loader.py:51-81).

    BOS + crc32-hashed word ids + EOS, padded to ``model_max_length``.
    crc32 (not Python's salted ``hash``) keeps ids equal across processes
    and across the two packages.
    """

    def __init__(self, vocab_size: int, model_max_length: int = 77,
                 bos: Optional[int] = 0, eos: int = 2, pad: int = 1):
        self.vocab_size = vocab_size
        self.model_max_length = model_max_length
        self.bos, self.eos, self.pad = bos, eos, pad

    def __call__(self, texts, max_length: Optional[int] = None, **_):
        max_length = max_length or self.model_max_length
        ids, mask = [], []
        for t in texts:
            toks = [self.bos] if self.bos is not None else []
            toks += [3 + (zlib.crc32(w.encode()) % (self.vocab_size - 4))
                     for w in t.split()][: max_length - len(toks) - 1]
            toks.append(self.eos)
            m = [1] * len(toks)
            while len(toks) < max_length:
                toks.append(self.pad)
                m.append(0)
            ids.append(toks)
            mask.append(m)
        return {"input_ids": np.asarray(ids, np.int32),
                "attention_mask": np.asarray(mask, np.int32)}


DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _check_vae_dtype(vae_dtype: str) -> None:
    if vae_dtype not in ("auto", *DTYPES):
        raise ValueError(f"vae_dtype {vae_dtype!r}: expected 'auto', "
                         f"'bfloat16' or 'float32'")


def fan_in_init(module: nn.Module, gen: torch.Generator) -> None:
    """The JAX ``init`` distributions: U(+-1/sqrt(fan_in)) kernels, zero
    biases, unit/zero norm affines (layers.py conv_init/linear_init) and
    N(0, 0.02) embedding tables."""
    for m in module.modules():
        if isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 0.02, generator=gen)
        elif isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            m.weight.uniform_(-bound, bound, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
        elif hasattr(m, "weight") and m.weight is not None \
                and m.weight.dim() == 1:  # GroupNorm / LayerNorm affine
            m.weight.fill_(1.0)
            m.bias.zero_()


class ModelBundle:
    """All models of one family on one device, plus tokenizers."""

    def __init__(self, family: str, tiny: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 device: torch.device | str = "cuda",
                 vae_dtype: str = "auto"):
        self.family = family
        self.spec = SPECS[family]
        self.dtype = dtype
        self.device = torch.device(device)
        _check_vae_dtype(vae_dtype)
        self.vae_dtype = vae_dtype
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' "
                               "explicitly to run on the CPU")
        # built on the meta device: no memory, no default init, until the
        # weights are materialized on the target device
        models_of = {"sd15": self._sd15_models, "sdxl": self._sdxl_models,
                     "sd3": self._sd3_models}
        with torch.device("meta"):
            self.models: Dict[str, nn.Module] = models_of[family](tiny)
        self.tokenizers = {
            "tokenizer": StubTokenizer(self.models["text_encoder"].cfg.vocab_size)}
        if "text_encoder_2" in self.models:
            self.tokenizers["tokenizer_2"] = StubTokenizer(
                self.models["text_encoder_2"].cfg.vocab_size)
        if "text_encoder_3" in self.models:
            # the JAX T5 stub (loader.py:100): no BOS, EOS 1, pad 0, 256 ids
            self.tokenizers["tokenizer_3"] = StubTokenizer(
                self.models["text_encoder_3"].cfg.vocab_size,
                model_max_length=256, bos=None, eos=1, pad=0)

    @staticmethod
    def _sd15_models(tiny: bool) -> Dict[str, nn.Module]:
        """The JAX registry's SD-1.5 bundle (registry.py:70-81): CLIP-L
        alone, last hidden state, no projection."""
        if tiny:
            # the text width equals TINY_UNET's cross_attention_dim (32)
            te = dataclasses.replace(clip_mod.TINY_CLIP, hidden_size=32,
                                     intermediate_size=64, projection_dim=None)
            unet, vae = unet_mod.TINY_UNET, vae_mod.TINY_VAE
        else:
            te = dataclasses.replace(clip_mod.CLIP_L, projection_dim=None)
            unet, vae = unet_mod.SD15_UNET, vae_mod.SD15_VAE
        return {"unet": unet_mod.UNet2DConditionModel(unet),
                "text_encoder": clip_mod.CLIPTextModel(te),
                "vae": vae_mod.AutoencoderKL(vae)}

    @staticmethod
    def _sdxl_models(tiny: bool) -> Dict[str, nn.Module]:
        if tiny:
            te1 = dataclasses.replace(clip_mod.TINY_CLIP, projection_dim=None,
                                      hidden_size=16, intermediate_size=32)
            te2 = dataclasses.replace(clip_mod.TINY_CLIP, projection_dim=48,
                                      hidden_size=16, intermediate_size=32)
            unet, vae = unet_mod.TINY_SDXL_UNET, vae_mod.TINY_VAE
        else:
            te1 = dataclasses.replace(clip_mod.CLIP_L, projection_dim=None)
            te2 = clip_mod.CLIP_G
            unet, vae = unet_mod.SDXL_UNET, vae_mod.SDXL_VAE
        return {"unet": unet_mod.UNet2DConditionModel(unet),
                "text_encoder": clip_mod.CLIPTextModel(te1),
                "text_encoder_2": clip_mod.CLIPTextModel(te2),
                "vae": vae_mod.AutoencoderKL(vae)}

    @staticmethod
    def _sd3_models(tiny: bool) -> Dict[str, nn.Module]:
        """The JAX registry's SD3 bundle (registry.py:97-118)."""
        if tiny:
            te1 = te2 = dataclasses.replace(
                clip_mod.TINY_CLIP, hidden_size=16, intermediate_size=32,
                projection_dim=16)
            # the T5 width equals the tiny MMDiT's joint_attention_dim (32)
            te3 = dataclasses.replace(t5_mod.TINY_T5, d_model=32, d_kv=8,
                                      num_heads=4)
            tr = mmdit_mod.TINY_MMDIT
            vae = dataclasses.replace(vae_mod.TINY_VAE, latent_channels=4,
                                      scaling_factor=1.5305,
                                      shift_factor=0.0609)
        else:
            te1, te2, te3 = clip_mod.CLIP_L_PROJ, clip_mod.CLIP_G, t5_mod.T5_XXL
            tr, vae = mmdit_mod.SD35_MEDIUM, vae_mod.SD3_VAE
        return {"transformer": mmdit_mod.SD3Transformer2DModel(tr),
                "text_encoder": clip_mod.CLIPTextModel(te1),
                "text_encoder_2": clip_mod.CLIPTextModel(te2),
                "text_encoder_3": t5_mod.T5EncoderModel(te3),
                "vae": vae_mod.AutoencoderKL(vae)}

    @property
    def denoiser(self):
        return self.models["transformer" if self.family == "sd3" else "unet"]

    @property
    def latent_channels(self) -> int:
        return self.denoiser.cfg.in_channels

    def param_dtype(self, name: str) -> torch.dtype:
        """Serving dtype of a component.  The VAE follows the JAX
        ``_vae_dtype`` rule (base.py:2813-2821) with the card in the TPU's
        place: "bfloat16" and "float32" force their dtype; "auto" is bf16
        on the card for every family, SDXL's force_upcast VAE included
        (bf16 has float32's exponent range, so the fp16 overflow that
        force_upcast guards against cannot happen), and float32 on the
        CPU."""
        if name == "vae":
            if self.vae_dtype == "auto":
                return (torch.bfloat16 if self.device.type == "cuda"
                        else torch.float32)
            return DTYPES[self.vae_dtype]
        return self.dtype

    def set_vae_dtype(self, vae_dtype: str) -> None:
        """Serve the VAE in ``vae_dtype`` from now on; a VAE that already
        holds weights is cast once (a bundle handed to a pipeline)."""
        _check_vae_dtype(vae_dtype)
        self.vae_dtype = vae_dtype
        self.models["vae"].to(self.param_dtype("vae"))

    def _materialize(self, name: str,
                     dtype: Optional[torch.dtype] = None) -> nn.Module:
        m = self.models[name].to(dtype or self.param_dtype(name))
        m = m.to_empty(device=self.device).requires_grad_(False).eval()
        self.models[name] = m
        return m

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> None:
        """Random weights, generated on the device in the serving dtype.

        Every tensor of the denoiser and text encoders is N(0, 0.02), as
        ``sduss_tpu.utils.random_params`` makes them; the VAE takes the
        fan-in init of the JAX ``init`` (which the JAX package uses for the
        SDXL VAE), so random-weight images have contrast.  The VAE is drawn
        in float32 and then cast, so one seed gives one VAE under every
        ``vae_dtype`` (JAX casts its float32 VAE at the decode).  The
        numbers differ from JAX's (another generator); tests that compare
        the two packages load JAX's weights with :meth:`load_state_dicts`
        instead.
        """
        for i, name in enumerate(sorted(self.models)):
            gen = torch.Generator(device=self.device).manual_seed(seed + i)
            if name == "vae":
                m = self._materialize(name, torch.float32)
                fan_in_init(m, gen)
                m.to(self.param_dtype(name))
            else:
                m = self._materialize(name)
                for p in m.parameters():
                    p.normal_(0.0, 0.02, generator=gen)

    @torch.no_grad()
    def replicate(self, device: torch.device | str) -> "ModelBundle":
        """A copy of the bundle on ``device``: the same modules, weights
        (copied tensor by tensor, so a request gives the same image on
        either copy), dtypes and tokenizers.  A dp replica on another card
        serves from it; replicas on one card share one bundle (the JAX
        engine shares ``first.bundle``, engine.py:60-64).  No tensor is
        copied on this bundle's device on the way."""
        other = copy.copy(self)
        other.device = torch.device(device)
        other.models = {}
        for name, m in self.models.items():
            # the copy's tensors start on the meta device, then are made
            # on the target and filled from this bundle's
            memo = {}
            for t in itertools.chain(m.parameters(), m.buffers()):
                e = torch.empty_like(t, device="meta")
                memo[id(t)] = (nn.Parameter(e, t.requires_grad)
                               if isinstance(t, nn.Parameter) else e)
            c = copy.deepcopy(m, memo).to_empty(device=other.device)
            for dst, src in zip(
                    itertools.chain(c.parameters(), c.buffers()),
                    itertools.chain(m.parameters(), m.buffers())):
                dst.copy_(src)
            other.models[name] = c.eval()
        return other

    @torch.no_grad()
    def load_state_dicts(self, state_dicts: Mapping[str, Mapping]) -> None:
        """Load every component from diffusers-named arrays or tensors.

        Each component takes exactly its module's keys (see
        :func:`select_state_dict`): a checkpoint's extra tensors, such as
        the VAE encoder and quant_conv (the port carries only the
        decoder), are ignored, and a missing one raises.
        """
        missing = set(self.models) - set(state_dicts)
        if missing:
            raise KeyError(f"no state dict for {sorted(missing)}")
        for name in self.models:
            self.load_component(name, state_dicts[name])

    @torch.no_grad()
    def load_component(self, name: str, sd: Mapping) -> None:
        """Load one component (see :meth:`load_state_dicts`)."""
        m = self._materialize(name)
        m.load_state_dict(select_state_dict(name, m.state_dict(), sd,
                                            self.param_dtype(name)),
                          strict=True)


def select_state_dict(component: str, keys, sd: Mapping,
                      dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Exactly ``keys`` (a module's state-dict keys) from ``sd`` (numpy
    arrays or tensors), upcast to float32 and cast to ``dtype``.

    A checkpoint's tensors that the module lacks are ignored, as the JAX
    converters ignore them (the VAE encoder, CLIP's ``position_ids``, T5's
    tied ``encoder.embed_tokens.weight``); a key the module needs and the
    checkpoint lacks raises a ``KeyError`` naming the component.  float16
    and bfloat16 go through float32 first, as the JAX loader's ``_to_jnp``
    upcasts them.
    """
    keys = list(keys)
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{component}: {len(missing)} of {len(keys)} tensors "
                       f"missing from the checkpoint, first {missing[:5]}")

    def f32(v):
        if isinstance(v, torch.Tensor):
            return v.float()
        return torch.from_numpy(np.array(v, np.float32))

    return {k: f32(sd[k]).to(dtype) for k in keys}

"""JAX parameter tree -> diffusers/transformers state dict (pure numpy).

The exact inverse of sduss_tpu/models/convert.py's ``convert_unet``,
``convert_clip``, ``convert_clip_vision``, ``convert_vae``,
``convert_mmdit`` and ``convert_t5``:
matmul kernels ``(in, out)`` go back
to torch's ``(out, in)``, conv kernels HWIO back to OIHW, and every tensor
gets its diffusers name again.  A UNet transformer's ``proj_in`` /
``proj_out`` follow their kernel: SDXL's linears become ``(C, C)``
weights, SD-1.5's 1x1 convs (``use_linear_projection=False``) diffusers'
``(C, C, 1, 1)`` ones, which ``convert_unet`` reads back with the flag
from the config.  This is how the JAX package's parameters
are carried into the port (``ModelBundle.load_state_dicts``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

StateDict = Dict[str, np.ndarray]


def _weight(kernel) -> np.ndarray:
    k = np.asarray(kernel)
    if k.ndim == 4:  # HWIO -> OIHW
        return np.ascontiguousarray(k.transpose(3, 2, 0, 1))
    return np.ascontiguousarray(k.T)  # (in, out) -> (out, in)


def _dense(sd: StateDict, prefix: str, p) -> None:
    """A Linear or Conv2d: ``kernel`` (+ ``bias``)."""
    sd[f"{prefix}.weight"] = _weight(p["kernel"])
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _norm(sd: StateDict, prefix: str, p) -> None:
    """A LayerNorm or GroupNorm: ``scale`` + ``bias``."""
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _resnet(sd: StateDict, prefix: str, p) -> None:
    for name in ("norm1", "norm2"):
        _norm(sd, f"{prefix}.{name}", p[name])
    for name in ("conv1", "conv2", "time_emb_proj", "conv_shortcut"):
        if name in p:
            _dense(sd, f"{prefix}.{name}", p[name])


def _attn(sd: StateDict, prefix: str, p) -> None:
    for name in ("to_q", "to_k", "to_v"):
        _dense(sd, f"{prefix}.{name}", p[name])
    _dense(sd, f"{prefix}.to_out.0", p["to_out"])


def _transformer(sd: StateDict, prefix: str, p) -> None:
    _norm(sd, f"{prefix}.norm", p["norm"])
    _dense(sd, f"{prefix}.proj_in", p["proj_in"])
    _dense(sd, f"{prefix}.proj_out", p["proj_out"])
    for t, blk in enumerate(p["blocks"]):
        bp = f"{prefix}.transformer_blocks.{t}"
        for name in ("norm1", "norm2", "norm3"):
            _norm(sd, f"{bp}.{name}", blk[name])
        _attn(sd, f"{bp}.attn1", blk["attn1"])
        _attn(sd, f"{bp}.attn2", blk["attn2"])
        _dense(sd, f"{bp}.ff.net.0.proj", blk["ff_geglu"])
        _dense(sd, f"{bp}.ff.net.2", blk["ff_out"])


def _level(sd: StateDict, prefix: str, blk) -> None:
    for j, r in enumerate(blk["resnets"]):
        _resnet(sd, f"{prefix}.resnets.{j}", r)
    for j, a in enumerate(blk.get("attentions", [])):
        if "group_norm" in a:  # VAE mid attention
            _norm(sd, f"{prefix}.attentions.{j}.group_norm", a["group_norm"])
            _attn(sd, f"{prefix}.attentions.{j}", a)
        else:
            _transformer(sd, f"{prefix}.attentions.{j}", a)
    if "downsample" in blk:
        _dense(sd, f"{prefix}.downsamplers.0.conv", blk["downsample"])
    if "upsample" in blk:
        _dense(sd, f"{prefix}.upsamplers.0.conv", blk["upsample"])


def unet_state_dict(p) -> StateDict:
    sd: StateDict = {}
    _dense(sd, "conv_in", p["conv_in"])
    for emb in ("time_embedding", "add_embedding"):
        if emb in p:
            _dense(sd, f"{emb}.linear_1", p[emb]["linear_1"])
            _dense(sd, f"{emb}.linear_2", p[emb]["linear_2"])
    for i, blk in enumerate(p["down_blocks"]):
        _level(sd, f"down_blocks.{i}", blk)
    _level(sd, "mid_block", p["mid_block"])
    for i, blk in enumerate(p["up_blocks"]):
        _level(sd, f"up_blocks.{i}", blk)
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    _dense(sd, "conv_out", p["conv_out"])
    return sd


def clip_state_dict(p) -> StateDict:
    pre = "text_model."
    sd: StateDict = {
        pre + "embeddings.token_embedding.weight": np.asarray(p["token_embedding"]),
        pre + "embeddings.position_embedding.weight": np.asarray(p["position_embedding"]),
    }
    _norm(sd, pre + "final_layer_norm", p["final_layer_norm"])
    for i, lyr in enumerate(p["layers"]):
        lp = f"{pre}encoder.layers.{i}"
        _norm(sd, f"{lp}.layer_norm1", lyr["ln1"])
        _norm(sd, f"{lp}.layer_norm2", lyr["ln2"])
        for jax_name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("out", "out_proj")):
            _dense(sd, f"{lp}.self_attn.{hf}", lyr[jax_name])
        _dense(sd, f"{lp}.mlp.fc1", lyr["fc1"])
        _dense(sd, f"{lp}.mlp.fc2", lyr["fc2"])
    if "text_projection" in p:
        _dense(sd, "text_projection", p["text_projection"])
    return sd


def clip_vision_state_dict(p) -> StateDict:
    """Inverse of ``convert_clip_vision`` (convert.py:68-93): transformers'
    ``CLIPVisionModelWithProjection`` names, ``pre_layrnorm`` spelt as
    transformers spells it."""
    pre = "vision_model."
    sd: StateDict = {
        pre + "embeddings.class_embedding": np.asarray(p["class_embedding"]),
        pre + "embeddings.position_embedding.weight":
            np.asarray(p["position_embedding"]),
    }
    _dense(sd, pre + "embeddings.patch_embedding", p["patch_embedding"])
    _norm(sd, pre + "pre_layrnorm", p["pre_layernorm"])
    _norm(sd, pre + "post_layernorm", p["post_layernorm"])
    _dense(sd, "visual_projection", p["visual_projection"])
    for i, lyr in enumerate(p["layers"]):
        lp = f"{pre}encoder.layers.{i}"
        _norm(sd, f"{lp}.layer_norm1", lyr["ln1"])
        _norm(sd, f"{lp}.layer_norm2", lyr["ln2"])
        for jax_name, hf in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                             ("out", "out_proj")):
            _dense(sd, f"{lp}.self_attn.{hf}", lyr[jax_name])
        _dense(sd, f"{lp}.mlp.fc1", lyr["fc1"])
        _dense(sd, f"{lp}.mlp.fc2", lyr["fc2"])
    return sd


def vae_state_dict(p) -> StateDict:
    sd: StateDict = {}
    for part in ("encoder", "decoder"):
        tree = p[part]
        _dense(sd, f"{part}.conv_in", tree["conv_in"])
        for i, blk in enumerate(tree.get("down_blocks", [])):
            _level(sd, f"{part}.down_blocks.{i}", blk)
        _level(sd, f"{part}.mid_block", tree["mid_block"])
        for i, blk in enumerate(tree.get("up_blocks", [])):
            _level(sd, f"{part}.up_blocks.{i}", blk)
        _norm(sd, f"{part}.conv_norm_out", tree["conv_norm_out"])
        _dense(sd, f"{part}.conv_out", tree["conv_out"])
    for name in ("quant_conv", "post_quant_conv"):
        if name in p:
            _dense(sd, name, p[name])
    return sd


def _scale(sd: StateDict, prefix: str, p) -> None:
    """An RMS norm: ``scale`` only."""
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])


def _mmdit_attn(sd: StateDict, prefix: str, p) -> None:
    _attn(sd, prefix, p)
    for name in ("norm_q", "norm_k", "norm_added_q", "norm_added_k"):
        if name in p:
            _scale(sd, f"{prefix}.{name}", p[name])
    for name in ("add_q_proj", "add_k_proj", "add_v_proj", "to_add_out"):
        if name in p:
            _dense(sd, f"{prefix}.{name}", p[name])


def mmdit_state_dict(p) -> StateDict:
    """Inverse of ``convert_mmdit`` (convert.py:305-337)."""
    sd: StateDict = {}
    _dense(sd, "pos_embed.proj", p["patch_embed"])
    for emb in ("timestep_embedder", "text_embedder"):
        for lin in ("linear_1", "linear_2"):
            _dense(sd, f"time_text_embed.{emb}.{lin}", p[emb][lin])
    _dense(sd, "context_embedder", p["context_embedder"])
    _dense(sd, "norm_out.linear", p["norm_out_proj"])
    _dense(sd, "proj_out", p["proj_out"])
    for i, blk in enumerate(p["blocks"]):
        pre = f"transformer_blocks.{i}"
        _dense(sd, f"{pre}.norm1.linear", blk["norm1_proj"])
        _dense(sd, f"{pre}.norm1_context.linear", blk["norm1_context_proj"])
        _mmdit_attn(sd, f"{pre}.attn", blk["attn"])
        _dense(sd, f"{pre}.ff.net.0.proj", blk["ff1"])
        _dense(sd, f"{pre}.ff.net.2", blk["ff2"])
        if "ff_context1" in blk:
            _dense(sd, f"{pre}.ff_context.net.0.proj", blk["ff_context1"])
            _dense(sd, f"{pre}.ff_context.net.2", blk["ff_context2"])
        if "attn2" in blk:
            _mmdit_attn(sd, f"{pre}.attn2", blk["attn2"])
    return sd


def t5_state_dict(p) -> StateDict:
    """Inverse of ``convert_t5`` (convert.py:96-118)."""
    sd: StateDict = {
        "shared.weight": np.asarray(p["token_embedding"]),
        "encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight":
            np.asarray(p["relative_attention_bias"]),
    }
    _scale(sd, "encoder.final_layer_norm", p["final_layer_norm"])
    for i, lyr in enumerate(p["layers"]):
        b = f"encoder.block.{i}.layer."
        _scale(sd, b + "0.layer_norm", lyr["ln_attn"])
        for name in ("q", "k", "v", "o"):
            _dense(sd, f"{b}0.SelfAttention.{name}", lyr[name])
        _scale(sd, b + "1.layer_norm", lyr["ln_ff"])
        for name in ("wi_0", "wi_1", "wo"):
            _dense(sd, f"{b}1.DenseReluDense.{name}", lyr[name])
    return sd


_BY_ROLE = {"unet": unet_state_dict, "clip": clip_state_dict,
            "clip_vision": clip_vision_state_dict,
            "vae": vae_state_dict, "transformer": mmdit_state_dict,
            "t5": t5_state_dict}


def jax_to_torch_state_dict(family_role: str, params) -> StateDict:
    """Convert one component's JAX parameter tree (numpy leaves).

    ``family_role`` is ``"unet"``, ``"transformer"`` (the SD3 MMDiT),
    ``"vae"``, ``"t5"``/``"text_encoder_3"``, ``"clip_vision"`` (the
    image tower) or a CLIP role (``"clip"``, ``"text_encoder"``,
    ``"text_encoder_2"``).
    """
    # text_encoder_3 (T5) first: every other text_encoder* role is CLIP
    if family_role == "text_encoder_3":
        role = "t5"
    elif family_role.startswith("text_encoder"):
        role = "clip"
    else:
        role = family_role
    try:
        fn = _BY_ROLE[role]
    except KeyError:
        raise ValueError(f"no converter for {family_role!r}; roles: unet, "
                         f"transformer, vae, t5/text_encoder_3, "
                         f"clip_vision, clip/text_encoder*") from None
    return fn(params)

"""The plain reference against the program's models at a tiny size, on
the same seeded weights and inputs (float32 on the CPU)."""

import pytest
import torch

from perfbench.lib import weights as wts
from perfbench.reference import clip as rclip
from perfbench.reference import models
from perfbench.tests import tiny


def pair(cfg, family):
    from sduss_tpu_torch.models.registry import ModelBundle

    t = wts.make(cfg, 11, "cpu", torch.float32)
    b = ModelBundle(family, tiny=True, dtype=torch.float32, device="cpu")
    b.load_state_dicts(t)
    return b, models.load(models.build(cfg), t, "cpu")


def inputs(cfg, res=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = cfg["unet"]
    hw = res // 8
    x = torch.randn(2, hw, hw, u["in_channels"], generator=g)
    t = torch.tensor([901.0, 901.0])
    ehs = torch.randn(2, 77, u["cross_attention_dim"], generator=g)
    added = None
    if u.get("addition_embed_type"):
        pooled = (u["projection_class_embeddings_input_dim"]
                  - 6 * u["addition_time_embed_dim"])
        added = {"text_embeds": torch.randn(2, pooled, generator=g),
                 "time_ids": torch.tensor([[res, res, 0, 0, res, res]] * 2,
                                          dtype=torch.float32)}
    return x, t, ehs, added


@pytest.mark.parametrize("cfg,family", [(tiny.SDXL, "sdxl"),
                                        (tiny.SD15, "sd15")])
def test_unet_full_and_deep_modes(cfg, family):
    b, ref = pair(cfg, family)
    x, t, ehs, added = inputs(cfg)
    with torch.no_grad():
        want = b.models["unet"](x, t, ehs, added_cond=added)
        got, feat = ref["unet"](x, t, ehs, added, boundary=1)
        assert torch.allclose(got, want, atol=1e-4, rtol=1e-4)
        out, pfeat = b.models["unet"](x, t, ehs, added_cond=added,
                                      deep_mode="full", deep_boundary=1)
        assert torch.allclose(feat, pfeat, atol=1e-4, rtol=1e-4)
        x2 = x + 0.1 * torch.randn_like(x)
        want2, _ = b.models["unet"](x2, t, ehs, added_cond=added,
                                    deep_mode="shallow", deep_state=pfeat,
                                    deep_boundary=1)
        got2, _ = ref["unet"](x2, t, ehs, added, deep=feat, boundary=1)
        assert torch.allclose(got2, want2, atol=1e-4, rtol=1e-4)
        assert not torch.allclose(got2, got, atol=1e-3)


def test_text_encoders_and_tokenizer():
    b, ref = pair(tiny.SDXL, "sdxl")
    texts = ["a cat on the moon", ""]
    ids = rclip.tokenize(texts, 1000)
    port_ids = b.tokenizers["tokenizer_2"](texts, max_length=77,
                                           padding="max_length",
                                           truncation=True)["input_ids"]
    assert (ids == port_ids).all()
    ids = torch.from_numpy(ids)
    with torch.no_grad():
        for name in ("text_encoder", "text_encoder_2"):
            o = b.models[name](ids, output_hidden_states=True)
            f, p = ref[name](ids, True)
            assert torch.allclose(o["hidden_states"][-2], f, atol=1e-5)
            assert torch.allclose(o["pooled"], p, atol=1e-5)


def test_vae_decode():
    b, ref = pair(tiny.SD15, "sd15")
    z = torch.randn(1, 8, 8, 4, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = b.models["vae"].decode(z)
        want = torch.clamp(want / 2 + 0.5, 0, 1) * 255
        got = ref["vae"].decode(z)
    assert torch.allclose(got, want, atol=1e-3)


def test_weights_are_seeded_and_shared():
    a = wts.make(tiny.SDXL, 5, "cpu")
    b = wts.make(tiny.SDXL, 5, "cpu")
    c = wts.make(tiny.SDXL, 6, "cpu")
    k = "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight"
    assert torch.equal(a["unet"][k], b["unet"][k])
    assert not torch.equal(a["unet"][k], c["unet"][k])
    assert a["unet"][k].dtype == torch.bfloat16
    std = a["unet"][k].float().std().item()
    assert abs(std - 64 ** -0.5) < 0.02
    assert torch.all(a["unet"]["conv_norm_out.weight"] == 1)
    assert torch.all(a["unet"]["conv_out.bias"] == 0)

"""A tiny cell for the CPU tests: the program's tiny SDXL and SD-1.5
bundles (``ModelBundle(tiny=True)``) described as configuration files,
float32, with a short closed-loop mix (or the open one that
``sweep.py`` sends) on 64 px patches."""

from __future__ import annotations

import copy

from perfbench.lib.spec import Cell

_CLIP = {"vocab_size": 1000, "hidden_size": 16, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 32,
         "max_position_embeddings": 77, "hidden_act": "quick_gelu"}
_VAE = {"latent_channels": 4, "out_channels": 3,
        "block_out_channels": [32, 64], "layers_per_block": 1,
        "norm_num_groups": 8, "scaling_factor": 0.18215}
_SCHED = {"kind": "EulerDiscreteScheduler", "num_train_timesteps": 1000,
          "beta_start": 0.00085, "beta_end": 0.012,
          "beta_schedule": "scaled_linear", "timestep_spacing": "leading",
          "steps_offset": 1, "prediction_type": "epsilon"}

SDXL = {
    "name": "tiny-sdxl", "family": "sdxl", "dtype": "float32",
    "program_tiny": True, "guidance_scale": 5.0,
    "unet": {"in_channels": 4, "out_channels": 4, "sample_size": 16,
             "block_out_channels": [32, 64],
             "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"],
             "layers_per_block": 1, "transformer_layers_per_block": [0, 1],
             "attention_head_dim": [2, 2], "cross_attention_dim": 32,
             "norm_num_groups": 8, "use_linear_projection": True,
             "addition_embed_type": "text_time",
             "addition_time_embed_dim": 32,
             "projection_class_embeddings_input_dim": 240},
    "text_encoder": dict(_CLIP, output="penultimate"),
    "text_encoder_2": dict(_CLIP, projection_dim=48, output="penultimate"),
    "vae": _VAE, "scheduler": _SCHED,
}

SD15 = {
    "name": "tiny-sd15", "family": "sd15", "dtype": "float32",
    "program_tiny": True, "guidance_scale": 7.5,
    "unet": {"in_channels": 4, "out_channels": 4, "sample_size": 16,
             "block_out_channels": [32, 64],
             "down_block_types": ["CrossAttnDownBlock2D", "DownBlock2D"],
             "layers_per_block": 1, "transformer_layers_per_block": [1, 0],
             "attention_head_dim": [2, 2], "cross_attention_dim": 32,
             "norm_num_groups": 8, "use_linear_projection": False},
    "text_encoder": dict(_CLIP, hidden_size=32, intermediate_size=64,
                         output="last"),
    "vae": _VAE, "scheduler": _SCHED,
}

OPEN = {"loop": "open", "rate_per_s": 6.0, "arrival_seed": 0,
        "lead_in_s": 0.5, "resolutions": [64, 128], "weights": [1, 1],
        "steps": 6, "policy": "fcfs_mixed", "slo": 5, "cache": "production",
        "scheduler": {"patch_size": 64, "max_batch_size": 4,
                      "batch_buckets": [1, 2, 4]},
        "prewarm_compositions": [], "sample": 2}

CLOSED = {"loop": "closed", "clients": 3, "client_ramp_s": 0.3,
          "lead_in_s": 0.5,
          "resolutions": [64], "weights": [1], "steps": 6,
          "policy": "fcfs_mixed", "slo": 5, "cache": "production",
          "scheduler": {"patch_size": 64, "max_batch_size": 4,
                        "batch_buckets": [1, 2, 4]},
          "prewarm_compositions": [], "sample": 2}

LIMITS = {"numbers": {"text_err": {"limit": 1e-4},
                      "eps_full_err": {"limit": 1e-3},
                      "eps_cached_err": {"limit": 1e-3},
                      "euler_err": {"limit": 1e-5},
                      "decode_err": {"limit": 0.05},
                      "cache_fp_err": {"limit": 1e-3},
                      "cache_rule_miss": {"limit": 0}}}
# CacheConfig.production(family, serving=True)'s schedule, as a cell's
# limits file states it
RULES = {"deep_warmup": 3, "pair_fraction": 0.3, "mse_threshold": 0.01,
         "tie_margin": 0.01}
INTERVAL = {"sdxl": 24, "sd15": 12}


def cell(config=SD15, mix=CLOSED, **mix_over) -> Cell:
    m = dict(copy.deepcopy(mix), **mix_over)
    limits = copy.deepcopy(LIMITS)
    limits["rules"] = dict(RULES, deep_interval=INTERVAL[config["family"]])
    return Cell(name="tiny", config=copy.deepcopy(config), traffic=m,
                chips=1, end_to_end=[], per_layer=[], limits=limits)

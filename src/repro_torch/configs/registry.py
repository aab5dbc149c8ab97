"""Architecture registry: --arch <id> -> ModelConfig (+ reduced smoke configs).

Every architecture of the JAX package's registry: the dense, moe, ssm
and hybrid families and the vision and audio frontends.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..models.config import ModelConfig
from . import (arctic_480b, grok_1_314b, h2o_danube_1_8b, hymba_1_5b,
               internvl2_1b, mamba2_780m, musicgen_medium, phi3_medium_14b,
               qwen1_5_110b, yi_34b)

__all__ = ["ARCHS", "get_config", "smoke_config"]

ARCHS: Dict[str, ModelConfig] = {
    "yi-34b": yi_34b.CONFIG,
    "phi3-medium-14b": phi3_medium_14b.CONFIG,
    "h2o-danube-1.8b": h2o_danube_1_8b.CONFIG,
    "qwen1.5-110b": qwen1_5_110b.CONFIG,
    "arctic-480b": arctic_480b.CONFIG,
    "grok-1-314b": grok_1_314b.CONFIG,
    "mamba2-780m": mamba2_780m.CONFIG,
    "hymba-1.5b": hymba_1_5b.CONFIG,
    "internvl2-1b": internvl2_1b.CONFIG,
    "musicgen-medium": musicgen_medium.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small layers/width/vocab.

    The same reduction as the JAX package's ``smoke_config``, so both
    sides build the same small model.
    """
    cfg = get_config(name)
    kw = dict(
        num_layers=2,
        d_model=64,
        vocab_size=128,
        rope_theta=10_000.0,
    )
    if cfg.family != "ssm":
        heads = 4
        kv = max(1, min(cfg.num_kv_heads, 2))
        kw.update(num_heads=heads, num_kv_heads=kv, head_dim=16,
                  d_ff=0 if cfg.d_ff == 0 else 128)
    if cfg.num_experts > 0:
        kw.update(num_experts=4, top_k=2, moe_d_ff=96, d_ff=128)
    if cfg.ssm_state > 0:
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16, ssm_expand=2)
    if cfg.sliding_window > 0:
        kw.update(sliding_window=16)
    if cfg.frontend == "vision":
        kw.update(vit_dim=32, num_patches=8)
    if cfg.frontend == "audio":
        kw.update(num_codebooks=2, vocab_size=64)
    return dataclasses.replace(cfg, **kw)

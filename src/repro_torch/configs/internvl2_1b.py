"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655. InternViT + InternLM2(Qwen2-0.5B) backbone.
[arXiv:2404.16821; hf]

The ViT frontend is a stub: the batch carries precomputed patch
embeddings (B, 256, 1024) under ``patch_embeds``; the model owns the MLP
projector + the LM backbone.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    frontend="vision",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    act="swiglu",
    qkv_bias=True,      # qwen2-style backbone
    vit_dim=1024,
    num_patches=256,
)

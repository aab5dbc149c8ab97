"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
llama-arch GQA. [arXiv:2403.04652; hf]
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    act="swiglu",
    rope_theta=5_000_000.0,
)

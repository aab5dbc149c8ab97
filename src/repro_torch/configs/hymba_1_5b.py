"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16. Parallel attn+mamba heads in every block.
[arXiv:2411.13676; hf]

Hymba uses sliding-window attention in most layers (global in a few);
the configuration models the SWA layers uniformly, which keeps the arch
sub-quadratic.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    hybrid=True,
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    sliding_window=1024,
    act="swiglu",
)

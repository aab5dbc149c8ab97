"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128e top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base; hf]

Snowflake Arctic is a dense-MoE hybrid: a (small) dense MLP residual runs
in parallel with the 128-expert top-2 MoE in every layer.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=2 * 7168,          # dense residual MLP width
    vocab_size=32000,
    num_experts=128,
    top_k=2,
    moe_d_ff=4864,
    dense_residual=True,
    act="swiglu",
)

"""h2o-danube-1.8b [dense]: 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000. llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

The SWA window makes this arch sub-quadratic: long_500k runs with a
window-sized KV ring buffer.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    act="swiglu",
    sliding_window=4096,
)

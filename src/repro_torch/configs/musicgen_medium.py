"""musicgen-medium [audio]: 48L d_model=1536 24H (kv=24 -> MHA) d_ff=6144
vocab=2048. Decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

The EnCodec frontend is a stub: the batch carries 4 parallel RVQ
codebook token streams (B, S, 4) (delay pattern applied upstream); the
model sums per-codebook embeddings and emits per-codebook logits.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    frontend="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    act="gelu",          # musicgen uses GELU FFN
    num_codebooks=4,
)

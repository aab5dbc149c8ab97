"""Unified model configuration (the port's own copy of ``ModelConfig``).

Field for field the same dataclass as the JAX package's, so a config
built on either side describes the same model; the two jnp dtype
methods become :meth:`compute_torch_dtype` / :meth:`param_torch_dtype`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..device import torch_dtype

__all__ = ["ModelConfig"]


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"  # dense | moe | ssm | hybrid | vlm | audio

    # backbone
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0            # 0 -> d_model // num_heads
    d_ff: int = 256              # dense-path FFN hidden size (0 for pure SSM)
    vocab_size: int = 256
    act: str = "swiglu"          # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    qkv_bias: bool = False       # qwen1.5 style
    sliding_window: int = 0      # 0 = full attention
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0            # expert hidden size (d_ff used if 0)
    dense_residual: bool = False  # arctic: dense MLP in parallel with MoE
    capacity_factor: float = 1.25
    router_z_loss: float = 1e-3
    load_balance_loss: float = 1e-2

    # SSM (mamba-2 SSD)
    ssm_state: int = 0           # N (state size per head); 0 = no ssm
    ssm_expand: int = 2
    ssm_head_dim: int = 64       # P
    ssm_chunk: int = 256
    conv_kernel: int = 4

    # hybrid (hymba): attention and SSM heads in parallel within a block
    hybrid: bool = False

    # modality frontends (precomputed embeddings)
    frontend: str = "none"       # none | vision | audio
    vit_dim: int = 1024
    num_patches: int = 256
    num_codebooks: int = 4

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def subquadratic(self) -> bool:
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def compute_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def param_torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ---------------------------------------------------------------- counts
    def _glu(self) -> bool:
        return self.act in ("swiglu", "geglu")

    def _ffn_params(self, hidden: int) -> int:
        mult = 3 if self._glu() else 2
        return mult * self.d_model * hidden

    def _attn_params(self) -> int:
        hd = self.resolved_head_dim
        q = self.d_model * self.num_heads * hd
        kv = 2 * self.d_model * self.num_kv_heads * hd
        o = self.num_heads * hd * self.d_model
        bias = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def _ssm_params(self) -> int:
        di, n, h = self.ssm_d_inner, self.ssm_state, self.ssm_num_heads
        in_proj = self.d_model * (2 * di + 2 * n + h)   # x, z, B, C, dt
        conv = self.conv_kernel * (di + 2 * n)
        out = di * self.d_model
        extra = 2 * h + di                              # A, dt_bias, D... approx
        return in_proj + conv + out + extra

    def layer_param_count(self, active_only: bool = False) -> int:
        """Parameters in one decoder layer (norms ignored: O(d))."""
        n = 2 * self.d_model  # the two norms, for honesty
        if self.family == "ssm":
            return n + self._ssm_params()
        if self.hybrid:
            n += self._attn_params() + self._ssm_params() + self._ffn_params(self.d_ff)
            return n
        n += self._attn_params()
        if self.num_experts > 0:
            e = self.top_k if active_only else self.num_experts
            n += e * self._ffn_params(self.expert_d_ff)
            n += self.d_model * self.num_experts  # router
            if self.dense_residual:
                n += self._ffn_params(self.d_ff)
        else:
            n += self._ffn_params(self.d_ff)
        return n

    def param_count(self, active_only: bool = False) -> int:
        emb = self.vocab_size * self.d_model
        if self.frontend == "audio":
            emb *= self.num_codebooks  # per-codebook embed + heads
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        if self.frontend == "audio":
            head = self.num_codebooks * self.vocab_size * self.d_model
        fe = 0
        if self.frontend == "vision":
            fe = self.vit_dim * self.d_model + 2 * self.d_model * self.d_model
        return emb + head + fe + self.num_layers * self.layer_param_count(active_only)

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)

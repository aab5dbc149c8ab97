"""Dispatching flash-attention wrapper under ``torch.autograd.Function``.

CPU tensors take the plain version (:func:`.ref.attention_ref`); CUDA
tensors launch the CUDA kernel, and anything else raises. The backward
recomputes through the plain version, as the JAX wrapper's ``custom_vjp``
does through its oracle: the forward kernel is the serving/prefill hot
path, and there is no backward kernel on either side.
"""

from __future__ import annotations

import torch

from .flash_attention import flash_attention_fwd
from .ref import attention_ref

__all__ = ["flash_attention", "launches"]

# Kernel launches through this wrapper (not plain-version calls).
launches = 0


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    global launches
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    out = flash_attention_fwd(q, k, v, causal=causal, window=window)
    launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        ctx.window = window
        return _forward(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = attention_ref(*args, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, args, g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,d); k,v: (B,S,K,d) -> (B,S,H,d)."""
    return _FlashAttention.apply(q, k, v, causal, window)

"""Dispatching paged decode-attention wrapper with a launch counter.

CPU tensors take the plain version (:func:`.ref.paged_attention_ref`);
plain CUDA tensors launch the CUDA kernel, and anything else raises:
another device, or a tensor subclass (``DTensor``, a fake tensor) on
CUDA, since no engine path shards the paged pool or traces it. There is
no fallback from the kernel to the plain version. Serving records no
gradient, so there is no ``autograd.Function``.

The kernel writes zeros into the rows at or past ``adv``, where the
plain version attends them too. The engine never samples those rows,
and no other row reads them: their keys are masked, their pool writes
dropped, and ``decode_chunk``'s MoE gives the real rows their expert
capacity first (``layers._route``), so the padding cannot displace a
real row whatever it holds.
"""

from __future__ import annotations

import torch

from .paged_attention import paged_attention_fwd
from .ref import paged_attention_ref

__all__ = ["paged_attention", "launches"]

# Kernel launches through this wrapper (not plain-version calls).
launches = 0


def paged_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    pool_k: torch.Tensor, pool_v: torch.Tensor,
                    block_table: torch.Tensor, pos: torch.Tensor, adv: torch.Tensor,
                    *, window: int = 0) -> torch.Tensor:
    """q: (B,C,H,hd); k, v: (B,C,K,hd); pool_k, pool_v: (NB,bs,K,hd);
    block_table: (B,nb); pos, adv: (B,) -> (B,C,H,hd)."""
    global launches
    if q.device.type == "cpu":
        return paged_attention_ref(q, k, v, pool_k, pool_v, block_table, pos, adv,
                                   window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for device {q.device}")
    subclass = {type(t).__name__ for t in (q, k, v, pool_k, pool_v)
                if type(t) is not torch.Tensor}
    if subclass:
        raise TypeError(f"paged_attention: the kernel takes plain CUDA tensors, not "
                        f"{sorted(subclass)}")
    out = paged_attention_fwd(q, k, v, pool_k, pool_v, block_table, pos, adv, window=window)
    launches += 1
    return out

"""Dispatching flash-attention wrapper under ``torch.autograd.Function``.

CPU tensors take the plain version (:func:`.ref.attention_ref`); CUDA
tensors launch the CUDA kernel, and anything else raises. The backward
recomputes through the plain version, as the JAX wrapper's ``custom_vjp``
does through its oracle: the forward kernel is the serving/prefill hot
path, and there is no backward kernel on either side.

``DTensor`` inputs (training under a mesh) are redistributed so that
each rank can attend on its own: the sequence dim of q, k and v is
gathered, the batch may stay sharded, and the heads stay sharded only
where q's and k/v's head shards keep every GQA group whole; then the
same ``Function`` runs on the local shards (the kernel on CUDA, counted
as above), and the result carries those placements.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

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


def _shard_placements(q: DTensor, k: DTensor) -> list:
    """Placements under which every rank attends on its own shards: the
    batch dim (0) keeps q's sharding where k shares it; the head dim (2)
    keeps it where q and k are sharded alike over mesh dims whose sizes
    divide both head counts, so that q's local heads are exactly the
    groups of k's local heads; everything else, the sequence included,
    is replicated."""
    mesh = q.device_mesh
    out = [p if p == Shard(0) and k.placements[i] == p else Replicate()
           for i, p in enumerate(q.placements)]
    heads = [i for i, p in enumerate(q.placements)
             if p == Shard(2) and k.placements[i] == p]
    n = math.prod(mesh.size(i) for i in heads)
    if heads and q.shape[2] % n == 0 and k.shape[2] % n == 0:
        for i in heads:
            out[i] = Shard(2)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,d); k,v: (B,S,K,d) -> (B,S,H,d)."""
    if isinstance(q, DTensor):
        mesh = q.device_mesh
        pl = _shard_placements(q, k)
        ql, kl, vl = (t.redistribute(mesh, pl).to_local() for t in (q, k, v))
        out = _FlashAttention.apply(ql, kl, vl, causal, window)
        return DTensor.from_local(out, mesh, pl, run_check=False)
    return _FlashAttention.apply(q, k, v, causal, window)

"""Dispatching SSD intra-chunk wrapper with a launch counter.

CPU tensors take the plain version (:func:`.ref.ssd_chunk_ref`); CUDA
tensors launch the CUDA kernels, and anything else raises. There is no
fallback from the kernels to the plain version.

Where a gradient is being recorded (grad enabled and an input requiring
it) the launch goes through :class:`_SSDChunk`, whose backward
recomputes through the plain version: neither the JAX package nor the
port has a backward kernel for this block (JAX differentiates its jnp
``ssd_apply``).

One call on the card launches two kernels, ``ssd_cb_kernel`` (C·Bᵀ once
per chunk) and then ``ssd_chunk_kernel`` (y_diag, states and decays for
every head), and ``launches`` counts it once: it counts calls of the
port's SSD kernel, the counterpart of one ``ssd_chunk_fwd`` of the JAX
package.

A ``DTensor`` raises: the ssm and hybrid families under a mesh are a
later slice of the port.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.distributed.tensor import DTensor

from .ref import ssd_chunk_ref
from .ssd_scan import ssd_chunk_fwd

__all__ = ["ssd_chunk", "launches"]

# Kernel calls through this wrapper, one per call (not plain-version calls).
launches = 0


def _launch(*ins: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    global launches
    out = ssd_chunk_fwd(*ins)
    launches += 1
    return out


class _SSDChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, C, B, x, dt, da):
        ctx.save_for_backward(C, B, x, dt, da)
        return _launch(C, B, x, dt, da)

    @staticmethod
    def backward(ctx, g_y, g_states, g_decays):
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = ssd_chunk_ref(*args)
            return torch.autograd.grad(out, args, (g_y, g_states, g_decays))


def ssd_chunk(C: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
              dt: torch.Tensor, da: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C, B: (b,nc,Q,N); x: (b,nc,Q,H,P); dt, da: (b,nc,Q,H) ->
    y_diag (b,nc,Q,H,P), states (b,nc,H,N,P), decays (b,nc,H), f32."""
    if any(isinstance(t, DTensor) for t in (C, B, x, dt, da)):
        raise NotImplementedError(
            "ssd_chunk on a DTensor: the ssm and hybrid families under a mesh "
            "come with a later slice of the port")
    if C.device.type == "cpu":
        return ssd_chunk_ref(C, B, x, dt, da)
    if C.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {C.device}")
    if any(t.requires_grad for t in (C, B, x, dt, da)) and torch.is_grad_enabled():
        return _SSDChunk.apply(C, B, x, dt, da)
    return _launch(C, B, x, dt, da)

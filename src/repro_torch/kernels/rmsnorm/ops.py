"""Dispatching RMSNorm wrapper with a launch counter.

CPU tensors take the plain version (:func:`.ref.rmsnorm_ref`); CUDA
tensors launch the CUDA kernel, and anything else raises. There is no
fallback from the kernel to the plain version.

Where a gradient is being recorded (grad enabled and x or scale
requiring it) the launch goes through :class:`_RMSNorm`, whose backward
recomputes through the plain version, as JAX differentiates its jnp
``rmsnorm``: there is no backward kernel on either side. Every other
call (serving) launches the kernel directly, with nothing between the
call and the launch but the check that picks the path.
"""

from __future__ import annotations

import torch

from .ref import rmsnorm_ref
from .rmsnorm import rmsnorm_fwd

__all__ = ["rmsnorm", "launches"]

# Kernel launches through this wrapper (not plain-version calls).
launches = 0


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    global launches
    out = rmsnorm_fwd(x, scale, eps)
    launches += 1
    return out


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _launch(x, scale, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        with torch.enable_grad():
            args = [t.detach().requires_grad_(True) for t in (x, scale)]
            out = rmsnorm_ref(*args, ctx.eps)
            dx, ds = torch.autograd.grad(out, args, g)
        return dx, ds, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    global launches
    if x.is_cuda:
        # serving reads two flags and launches: neither input requires grad
        if (x.requires_grad or scale.requires_grad) and torch.is_grad_enabled():
            return _RMSNorm.apply(x, scale, eps)
        out = rmsnorm_fwd(x, scale, eps)     # the light launch: inline
        launches += 1
        return out
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")

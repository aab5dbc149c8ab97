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

A ``DTensor`` (training under a mesh) is redistributed so that the
normalised last dim is whole on every rank, and the same path then runs
on each rank's local shard: the kernel for a CUDA shard, counted as
above. The result carries the input's placements.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

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


def on_shards(local_fn, x: DTensor, scale: torch.Tensor, eps: float) -> DTensor:
    """``local_fn(x, scale, eps)`` on each rank's shard of ``x``, with the
    last dim gathered first and ``scale`` replicated. The scale's gradient
    is a partial sum over the mesh dims that shard x's rows."""
    mesh = x.device_mesh
    last = x.dim() - 1
    pl = [Replicate() if isinstance(p, Partial) or p == Shard(last) else p
          for p in x.placements]
    xl = x.redistribute(mesh, pl).to_local()
    rep = [Replicate()] * mesh.ndim
    if isinstance(scale, DTensor):
        grad_pl = [Partial() if isinstance(p, Shard) else Replicate() for p in pl]
        sl = scale.redistribute(mesh, rep).to_local(grad_placements=grad_pl)
    else:
        sl = scale
    out = local_fn(xl, sl, eps)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    global launches
    if isinstance(x, DTensor):
        return on_shards(rmsnorm, x, scale, eps)
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

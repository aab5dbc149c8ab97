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

``DTensor`` inputs (training under a mesh) run on each rank's local
shards (:func:`on_shards`): x, dt and da keep their batch (dim 0) and
head (dim 3) sharding where the heads divide evenly, C and B keep only
their batch sharding, and the chunk and its Q rows are whole; then the
same path runs on the local tensors (the kernels on CUDA, counted as
above) and the outputs carry the matching placements. Nothing is
gathered to the full tensor.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ...parallel.sharding import local_shard
from .ref import ssd_chunk_ref
from .ssd_scan import ssd_chunk_fwd

__all__ = ["ssd_chunk", "on_shards", "Layout", "shard_layout", "launches"]

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


class Layout(NamedTuple):
    """Placements under which every rank runs its own SSD block."""
    x: list          # x (b,nc,Q,H,P), dt, da (b,nc,Q,H) and y_diag
    cb: list         # C, B (b,nc,Q,N): the batch sharding only
    cb_grad: list    # C's and B's gradients: partial sums over the head shards
    heads: list      # states (b,nc,H,N,P) and decays (b,nc,H)


def shard_layout(x: DTensor) -> Layout:
    """The layout for x: the batch dim (0) keeps x's sharding; the head
    dim (3) keeps it where the mesh dims sharding it divide H; the chunk
    and Q dims, and anything else, are replicated."""
    mesh = x.device_mesh
    pl = [p if p == Shard(0) else Replicate() for p in x.placements]
    heads = [i for i, p in enumerate(x.placements) if p == Shard(3)]
    if heads and x.shape[3] % math.prod(mesh.size(i) for i in heads) == 0:
        for i in heads:
            pl[i] = Shard(3)
    cb = [p if p == Shard(0) else Replicate() for p in pl]
    return Layout(pl, cb, [Partial() if p == Shard(3) else q for p, q in zip(pl, cb)],
                  [Shard(2) if p == Shard(3) else p for p in pl])


def on_shards(local_fn, C: torch.Tensor, B: torch.Tensor, x: DTensor,
              dt: torch.Tensor, da: torch.Tensor
              ) -> Tuple[DTensor, DTensor, DTensor]:
    """``local_fn(C, B, x, dt, da)`` on each rank's local shards, placed by
    :func:`shard_layout`: C and B, shared by every head, keep only their
    batch sharding, and their gradients are partial sums over the mesh
    dims that shard the heads. Returns y_diag placed as x, states and
    decays with the heads on dim 2."""
    mesh = x.device_mesh
    lay = shard_layout(x)
    y, states, decays = local_fn(
        local_shard(C, mesh, lay.cb, lay.cb_grad), local_shard(B, mesh, lay.cb, lay.cb_grad),
        *(local_shard(t, mesh, lay.x) for t in (x, dt, da)))
    return (DTensor.from_local(y, mesh, lay.x, run_check=False),
            DTensor.from_local(states, mesh, lay.heads, run_check=False),
            DTensor.from_local(decays, mesh, lay.heads, run_check=False))


def ssd_chunk(C: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
              dt: torch.Tensor, da: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C, B: (b,nc,Q,N); x: (b,nc,Q,H,P); dt, da: (b,nc,Q,H) ->
    y_diag (b,nc,Q,H,P), states (b,nc,H,N,P), decays (b,nc,H), f32."""
    if isinstance(x, DTensor):
        return on_shards(ssd_chunk, C, B, x, dt, da)
    if C.device.type == "cpu":
        return ssd_chunk_ref(C, B, x, dt, da)
    if C.device.type != "cuda":
        raise ValueError(f"ssd_chunk: no kernel for device {C.device}")
    if any(t.requires_grad for t in (C, B, x, dt, da)) and torch.is_grad_enabled():
        return _SSDChunk.apply(C, B, x, dt, da)
    return _launch(C, B, x, dt, da)

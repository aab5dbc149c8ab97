"""Distributed-optimization collectives: compressed cross-pod grad sync.

The pod axis rides the slow network between pods, so the cross-pod
gradient reduction is the bandwidth-starved collective at multi-pod
scale. Gradients are quantized to int8 with per-tensor scales and error
feedback (1-bit-Adam-style residual correction) before the pod
all-reduce — 2x wire-byte reduction vs bf16, 4x vs f32, with the
compression error re-injected next step so convergence is preserved.

The port of the JAX package's ``parallel/collectives.py`` on
``torch.distributed``: where JAX makes the pod axis manual under
``shard_map``, the port runs the per-pod computation on the mesh
without its pod axis (DTensor keeps the other axes) and reduces over
the pod axis's process group explicitly, an int8 SUM ``all_reduce``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate

from ..tree import tree_leaves, tree_map, tree_unflatten
from .sharding import (ShardingRules, current_rules, mesh_axis_sizes, to_plain,
                       use_rules)

__all__ = ["compressed_pod_mean", "make_compressed_grad_sync", "zeros_like_tree"]


def zeros_like_tree(tree: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Zeros shaped (and, for a ``DTensor``, placed) like each leaf."""
    return tree_map(lambda a: torch.zeros_like(a, dtype=dtype), tree)


def _no_partial(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` holding pending partial sums, reduced to replicas."""
    if isinstance(t, DTensor) and any(isinstance(p, Partial) for p in t.placements):
        return t.redistribute(t.device_mesh, [Replicate() if isinstance(p, Partial)
                                              else p for p in t.placements])
    return t


def _quantize_psum_dequantize(g: torch.Tensor, err: torch.Tensor, group: Any,
                              npods: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: error-feedback int8 pod-mean. ``g`` and ``err`` are this
    pod's values, plain or ``DTensor`` over the mesh's other axes."""
    g32 = _no_partial(g).float() + _no_partial(err).float()
    # shared scale so dequantization is exact across pods; the grid is
    # pre-divided by npods so the SUM of quantized values still fits int8
    # and the wire stays at 1 byte/element (vs 2 for bf16, 4 for f32)
    amax = to_plain(torch.amax(torch.abs(g32)))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-20) * npods / 127.0
    q = torch.clamp(torch.round(g32 / scale), -(127 // npods),
                    127 // npods).to(torch.int8)
    deq_local = q.float() * scale
    new_err = (g32 - deq_local).to(err.dtype)           # feedback residual
    summed = (q.to_local() if isinstance(q, DTensor) else q).clone()
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)  # int8 on the wire
    mean = summed.float() * scale / npods
    if isinstance(q, DTensor):
        mean = DTensor.from_local(mean, q.device_mesh, q.placements, run_check=False,
                                  shape=q.shape, stride=q.stride())
    return mean.to(g.dtype), new_err


def compressed_pod_mean(grads: Any, err: Any, group: Any = None,
                        npods: int = 2) -> Tuple[Any, Any]:
    """Tree-wise error-feedback compressed mean over the process group
    ``group`` (``None`` = the default group) of ``npods`` ranks, one per
    pod. Returns the mean gradients and the new error-feedback tree."""
    outs = [_quantize_psum_dequantize(g, e, group, npods)
            for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    return (tree_unflatten(grads, [o[0] for o in outs]),
            tree_unflatten(grads, [o[1] for o in outs]))


def make_compressed_grad_sync(mesh: Any, grad_fn: Callable, axis: str = "pod"):
    """Wrap a per-pod grad_fn with compressed cross-pod averaging.

    grad_fn(params, batch) -> (grads, metrics). The returned
    sync(params, batch, err) -> (grads, new_err, metrics) takes the
    global batch, the same on every rank, and gives ``grad_fn`` this
    rank's pod's slice of its leading dim, under the current rules with
    the mesh cut to its other axes (DTensor keeps those); the gradients
    then go through :func:`compressed_pod_mean` over the pod axis's
    group, and the metrics are averaged over the pods.
    """
    sizes = mesh_axis_sizes(mesh)
    npods = sizes.get(axis, 1)
    group = mesh.get_group(axis)
    pod = mesh.get_local_rank(axis)
    others = tuple(n for n in sizes if n != axis)
    sub = mesh[others] if others else None

    def sync(params: Any, batch: Dict[str, torch.Tensor], err: Any):
        local = {}
        for k, v in batch.items():
            per = v.shape[0] // npods
            local[k] = v[pod * per:(pod + 1) * per]
        rules = current_rules()
        inner = (ShardingRules(rules.rules, sub, rules.enabled) if rules is not None
                 else None)
        with use_rules(inner):
            grads, metrics = grad_fn(params, local)
        grads, new_err = compressed_pod_mean(grads, err, group, npods)
        out = {}
        for k, m in metrics.items():
            m = to_plain(m.detach()).float().clone()
            dist.all_reduce(m, op=dist.ReduceOp.SUM, group=group)
            out[k] = m / npods
        return grads, new_err, out

    return sync

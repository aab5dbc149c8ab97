"""Logical-axis sharding rules (MaxText-style) for params and activations.

Parameters and activations are annotated with *logical* axis names
("embed", "heads_tp", "batch", ...). A :class:`ShardingRules` table maps
logical names to mesh axes; the mapping is what a planner varies, while
model code never changes.

Baseline rules:
  batch    -> ("pod", "data")   pure DP across pods, DP within pod
  embed    -> "data"            FSDP: params sharded over the data axis
  *_tp     -> "model"           tensor parallelism
  experts  -> "model"           expert parallelism shares the TP axis

The port of the JAX package's ``parallel/sharding.py`` on DTensor. A
spec (:func:`logical_to_pspec`) is what JAX's ``PartitionSpec`` holds,
one entry per tensor dim: ``None``, a mesh axis name or a tuple of them.
:func:`placements` turns it into DTensor placements, one per mesh dim,
and :func:`constrain` redistributes a ``DTensor`` to them, where JAX
adds a sharding constraint for XLA to honour.

A tensor dim sharded over a tuple of mesh axes is laid out major to
minor in the tuple's order in JAX, and in mesh-dim order in DTensor,
which nests ``Shard`` placements by mesh dim. The two agree when the
tuple lists its axes in mesh-dim order, as every rule here does;
:func:`placements` refuses a spec where they would not.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Partial, Placement, Replicate,
                                      Shard, distribute_tensor)

from ..tree import tree_map

__all__ = ["ShardingRules", "use_rules", "current_rules", "active_mesh", "constrain",
           "logical_to_pspec", "placements", "param_shardings",
           "distribute_tree", "distribute_batch", "batch_placements", "mesh_axis_sizes",
           "from_local_shard", "local_einsum", "local_shard", "replicated_like", "to_plain",
           "whole_dims",
           "BASE_RULES"]

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]

# logical axis -> mesh axes (None = replicated)
BASE_RULES: Dict[str, MeshAxes] = {
    # activations
    "batch": ("pod", "data"),
    # Sequence parallelism is the BASELINE: GQA kv-head counts (8) don't
    # divide model=16, so head-TP alone would replicate attention across
    # the model axis; sharding seq over "model" keeps the axis busy and
    # cuts activation residency 16x.
    "seq": "model",
    "act_embed": None,
    "act_heads": "model",
    "act_kv": "model",
    "act_ff": "model",
    "act_vocab": "model",
    "act_experts": "model",
    "moe_cap": None,          # expert-buffer capacity dim (grok: "data")
    "seq_kv": "model",        # KV-cache sequence dim (caches shard here
                              # when kv-head counts can't split the axis)
    # params
    "layer": None,
    "embed": "data",          # FSDP dim
    "vocab_tp": "model",
    "heads_tp": "model",
    "kv_tp": "model",
    "ffn_tp": "model",
    "experts": "model",
    "expert_embed": "data",   # expert weights' d_model dim (FSDP)
    "expert_ffn": None,
    "ssm_inner_tp": "model",
    "ssm_state": None,
    "ssm_heads": None,
    "conv_k": None,
    "norm": None,
    "vit": None,
    "codebooks": None,
}


def mesh_axis_sizes(mesh: Any) -> Dict[str, int]:
    """Axis name -> size, in mesh-dim order, of a ``DeviceMesh`` or of
    any object with ``axis_names`` and ``axis_sizes`` (a JAX mesh has
    both); ``{}`` for no mesh."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(zip(mesh.axis_names, mesh.axis_sizes))


@dataclass
class ShardingRules:
    rules: Dict[str, MeshAxes] = field(default_factory=lambda: dict(BASE_RULES))
    mesh: Any = None                 # a DeviceMesh, or axis names and sizes
    enabled: bool = True

    def updated(self, overrides: Dict[str, MeshAxes]) -> "ShardingRules":
        r = dict(self.rules)
        r.update(overrides)
        return ShardingRules(r, self.mesh, self.enabled)

    def resolve(self, logical: Optional[str]) -> MeshAxes:
        if logical is None:
            return None
        if logical not in self.rules:
            raise KeyError(f"unknown logical axis {logical!r}")
        axes = self.rules[logical]
        if self.mesh is None:
            return axes
        names = mesh_axis_sizes(self.mesh)
        if isinstance(axes, tuple):
            # drop axes absent from the mesh (e.g. no "pod" on single-pod)
            axes = tuple(a for a in axes if a in names)
            return axes if axes else None
        if isinstance(axes, str) and axes not in names:
            return None
        return axes


_ctx = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_ctx, "rules", None)


def active_mesh() -> Any:
    """The mesh of the current rules, or None without rules or mesh."""
    rules = current_rules()
    if rules is None or not rules.enabled:
        return None
    return rules.mesh


@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield rules
    finally:
        _ctx.rules = prev


def logical_to_pspec(logical_axes: Sequence[Optional[str]],
                     rules: ShardingRules,
                     shape: Optional[Sequence[int]] = None) -> Spec:
    """Resolve logical axes to a spec: per tensor dim ``None``, one mesh
    axis or a tuple of them, as JAX's ``PartitionSpec``.

    When ``shape`` is given, mesh axes whose size does not divide the
    tensor dim are dropped (replicate-fallback): e.g. 8 KV heads cannot
    shard over model=16, so that dim replicates.
    """
    spec: List[MeshAxes] = []
    used: set = set()
    mesh_sizes = mesh_axis_sizes(rules.mesh)
    for i, ax in enumerate(logical_axes):
        m = rules.resolve(ax)
        # a mesh axis may shard at most one tensor dim
        if m is None:
            spec.append(None)
            continue
        ms = (m,) if isinstance(m, str) else tuple(m)
        ms = tuple(a for a in ms if a not in used)
        if shape is not None and ms:
            dim = shape[i]
            # drop axes from the right until the product divides the dim
            while ms:
                prod = 1
                for a in ms:
                    prod *= mesh_sizes.get(a, 1)
                if prod and dim % prod == 0:
                    break
                ms = ms[:-1]
        used.update(ms)
        if not ms:
            spec.append(None)
        elif len(ms) == 1:
            spec.append(ms[0])
        else:
            spec.append(ms)
    return tuple(spec)


def placements(spec: Sequence[MeshAxes], mesh: Any) -> List[Placement]:
    """DTensor placements, one per mesh dim, for a spec: ``Shard(d)``
    where the mesh axis shards tensor dim ``d``, ``Replicate()``
    elsewhere. A dim sharded over a tuple must list its axes in mesh-dim
    order: JAX lays such a dim out major to minor in the tuple's order,
    DTensor in mesh-dim order."""
    order = {name: i for i, name in enumerate(mesh_axis_sizes(mesh))}
    out: List[Placement] = [Replicate() for _ in order]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        dims = [order[a] for a in axes]
        if dims != sorted(dims):
            raise ValueError(
                f"tensor dim {d} is sharded over {axes}, not in the mesh's "
                f"dim order {tuple(order)}: DTensor would lay it out in "
                f"mesh-dim order, JAX in the tuple's")
        for i in dims:
            out[i] = Shard(d)
    return out


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """Redistribute a ``DTensor`` to the active rules' placements for
    ``logical_axes``; a no-op without rules or mesh, and on a plain
    tensor."""
    rules = current_rules()
    if rules is None or not rules.enabled or rules.mesh is None:
        return x
    if x.dim() != len(logical_axes):
        raise ValueError(f"constrain: rank {x.dim()} vs axes {logical_axes}")
    if not isinstance(x, DTensor):
        return x
    spec = logical_to_pspec(logical_axes, rules, x.shape)
    return x.redistribute(rules.mesh, placements(spec, rules.mesh))


def param_shardings(spec_tree: Any, rules: ShardingRules,
                    abstract_tree: Any = None) -> Any:
    """Map a ``Mode.SPEC`` tree (leaves = logical-axis tuples) to DTensor
    placements on ``rules.mesh``. ``abstract_tree`` (matching tensors,
    e.g. on ``meta``) enables the divisibility fallback per leaf."""
    if abstract_tree is None:
        return tree_map(lambda axes: placements(logical_to_pspec(axes, rules),
                                                rules.mesh), spec_tree)
    return tree_map(lambda axes, a: placements(
        logical_to_pspec(axes, rules, a.shape), rules.mesh), spec_tree, abstract_tree)


def distribute_tree(tree: Any, shardings: Any, mesh: Any) -> Any:
    """Every leaf of ``tree`` as a ``DTensor`` on ``mesh`` with the
    placements at its path in ``shardings`` (:func:`param_shardings`).
    Each rank passes the same full values; a rank keeps its shard."""
    return tree_map(lambda pl, t: distribute_tensor(t, mesh, pl), shardings, tree)


def distribute_batch(batch: Mapping[str, torch.Tensor], rules: ShardingRules
                     ) -> Dict[str, torch.Tensor]:
    """Each batch tensor as a ``DTensor`` sharded over ``"batch"`` (its
    leading dim) on ``rules.mesh``; tensors that already are pass."""
    out = {}
    for k, v in batch.items():
        if not isinstance(v, DTensor):
            v = distribute_tensor(v, rules.mesh, batch_placements(v, rules))
        out[k] = v
    return out


def batch_placements(v: torch.Tensor, rules: ShardingRules) -> List[Placement]:
    """A batch tensor's placements: its leading dim over ``"batch"``."""
    axes = ("batch",) + (None,) * (v.dim() - 1)
    return placements(logical_to_pspec(axes, rules, v.shape), rules.mesh)


def whole_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """A ``DTensor`` redistributed so that tensor ``dims`` are whole on
    every rank (their ``Shard`` placements replicated, the others kept);
    a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    pl = [Replicate() if isinstance(p, Shard) and p.dim in dims else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(x.device_mesh, pl)


def replicated_like(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` as a replicated ``DTensor`` on ``like``'s mesh when ``like``
    is a ``DTensor`` and ``t`` is not (the same values on every rank);
    otherwise ``t``. DTensor ops take no plain tensor beside a DTensor
    but a scalar."""
    if isinstance(like, DTensor) and not isinstance(t, DTensor):
        mesh = like.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t


def local_shard(t: torch.Tensor, mesh: Any, pl: Sequence[Placement],
                grad_pl: Optional[Sequence[Placement]] = None) -> torch.Tensor:
    """This rank's shard of ``t`` once redistributed to ``pl`` on
    ``mesh``, a plain tensor for code that runs on local shards (a plain
    ``t`` is taken as the same value on every rank). Autograd takes the
    shard's gradient as placed by ``grad_pl`` (default ``pl``): a value
    that every rank uses whole beside other operands' shards gets a
    ``Partial`` gradient over the mesh dims that shard them."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, pl).to_local(grad_placements=grad_pl)


def local_einsum(eq: str, x: torch.Tensor, w: torch.Tensor, op=None) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` and a weight
    ``w``; under a mesh (either a ``DTensor``) it runs on this rank's
    shards and returns a ``DTensor``, where DTensor's own propagation may
    shard the product's flattened output dims unevenly (a head count the
    mesh dim does not divide) or flatten a sharded sequence into rows.

    Per mesh dim: ``x`` split over a dim of its own (rows) keeps it and
    gathers ``w`` (whose gradient is then a partial sum); both split over
    the same dim keep it (a contracted one gives a ``Partial`` output);
    ``w`` split over a dim of its own (tensor parallel) keeps it and
    gathers ``x`` (whose gradient is partial); anything else is gathered.
    A ``Partial`` operand is reduced first. ``op(x, w)``, where given,
    computes the product instead of ``torch.einsum`` (the same op as a
    caller's plain path, so that a mesh of one rank gives its bits)."""
    op = op or (lambda a, b: torch.einsum(eq, a, b))
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return op(x, w)
    mesh = (x if isinstance(x, DTensor) else w).device_mesh
    ins, out = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    rep = [Replicate()] * mesh.ndim
    px = x.placements if isinstance(x, DTensor) else rep
    pw = w.placements if isinstance(w, DTensor) else rep
    x_pl, w_pl, o_pl, x_g, w_g = [], [], [], [], []
    for a, b in zip(px, pw):
        la = xs[a.dim] if isinstance(a, Shard) else None
        lb = ws[b.dim] if isinstance(b, Shard) else None
        if la is not None and la == lb:
            o = Shard(out.index(la)) if la in out else Partial()
            pick = (a, b, o, a, b)
        elif la is not None and la not in ws:
            pick = (a, Replicate(), Shard(out.index(la)), a, Partial())
        elif lb is not None and lb not in xs:
            pick = (Replicate(), b, Shard(out.index(lb)), Partial(), b)
        else:
            pick = (Replicate(),) * 5
        for acc, q in zip((x_pl, w_pl, o_pl, x_g, w_g), pick):
            acc.append(q)
    y = op(local_shard(x, mesh, x_pl, x_g), local_shard(w, mesh, w_pl, w_g))
    sizes = dict(zip(xs, x.shape)) | dict(zip(ws, w.shape))
    return from_local_shard(y, mesh, o_pl, [sizes[c] for c in out])


def from_local_shard(t: torch.Tensor, mesh: Any, pl: Sequence[Placement],
                     shape: Sequence[int]) -> torch.Tensor:
    """``DTensor.from_local`` of this rank's shard ``t`` of a tensor of
    global ``shape`` (contiguous), placed by ``pl``; no check, no
    allocation at the global shape."""
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return DTensor.from_local(t, mesh, pl, run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(strides)))


def to_plain(t: torch.Tensor) -> torch.Tensor:
    """The full value of a ``DTensor`` on every rank (a partial sum is
    reduced first); a plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t

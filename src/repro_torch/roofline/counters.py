"""Per-rank counts of one traced step: FLOPs, bytes, collectives, peak memory.

The port's counterpart of the JAX package's ``roofline/hlo.py`` together
with XLA's ``cost_analysis()`` and ``memory_analysis()``. JAX reads them
off the compiled, SPMD-partitioned module, one program per device; here
:class:`StepCounter`, a dispatch mode, watches the ops one rank runs while
the step executes, eagerly, on fake tensors over a fake process group
(``launch/dryrun.py``) or on real tensors on a card.

* **FLOPs per rank.** A ``DTensor`` op is handed back to DTensor, which
  runs it as local ops on this rank's shards (and as the collectives of
  its redistributions); the counter sees those and applies torch's flop
  formulas (``torch.utils.flop_counter``: the matrix products) to them.
  For a DTensor op this is its global count scaled by the output's local
  over global numel and divided by the size of every mesh dim on which
  the output is ``Partial``; a replicated computation counts in full on
  every rank. Plain-tensor ops (no mesh) count as they are. Elementwise
  work has no formula and is not counted (XLA counts it).
* **Bytes per rank.** Each op's operand and result bytes at local shapes:
  the eager path's traffic, every intermediate read and written once
  (``bytes_by_op`` splits them by op). It is not XLA's ``bytes accessed``
  of a fused module (which never writes a fused intermediate out); views,
  allocations, collectives and a fake tensor's metadata queries move
  none here. A hand-written kernel's launch is no ATen op: on a card the
  counter sees only the allocation of its output.
* **Collective bytes**, by kind and by mesh axis: each ``c10d_functional``
  or ``c10d`` collective's result bytes (the per-rank payload, as
  ``hlo.py`` sums result shapes), under the mesh dim whose process group
  it names, ``{axis: {kind: bytes}}``; a group of several mesh dims is
  ``span<n>``, as in ``hlo.py``. The kinds take XLA's names
  (``all-gather``, ``reduce-scatter``, ``all-reduce``, ``all-to-all``,
  ``collective-permute``, ``collective-broadcast``). On a CPU mesh DTensor
  moves a shard from one tensor dim to another by an all-gather and a
  chunk (gloo has no all-to-all), which the counter records as the
  all-gather it is.
* **Peak live storage bytes per rank**: every storage a counted op makes
  is live until its last tensor dies; :meth:`StepCounter.hold` adds the
  storages the caller holds (the state, the batch), as a launcher holds
  them across its step.
"""

from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, Iterable, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["StepCounter", "COLLECTIVE_KINDS", "collective_bytes_by_kind",
           "collective_bytes_by_axis_kind", "tensors_of", "storage_bytes"]

aten = torch.ops.aten

# op name (without its namespace and trailing underscore) -> XLA's kind
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter": "reduce-scatter",
    "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce", "allreduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all", "alltoall": "all-to-all",
    "alltoall_base": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "broadcast": "collective-broadcast", "scatter": "collective-broadcast",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
_NO_TRAFFIC = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
               aten.new_empty_strided, aten.detach, aten.lift_fresh,
               aten._local_scalar_dense}


def tensors_of(tree: Any) -> Iterable[torch.Tensor]:
    """Every tensor leaf of a pytree, a ``DTensor`` as its local shard."""
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, DTensor):
            yield leaf._local_tensor
        elif isinstance(leaf, torch.Tensor):
            yield leaf


def storage_bytes(tree: Any, exclude: Optional[set] = None) -> int:
    """The bytes of the distinct storages of ``tree``'s tensors (local
    shards), leaving out the storages whose ids are in ``exclude``."""
    seen = set(exclude or ())
    total = 0
    for t in tensors_of(tree):
        s = t.untyped_storage()
        if id(s) not in seen:
            seen.add(id(s))
            total += s.nbytes()
    return total


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what one rank runs while it is entered (see the module
    docstring). ``mesh`` names the mesh dims of the process groups; with
    no mesh every collective is ``span<n>``."""

    def __init__(self, mesh: Any = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.bytes_by_op: Dict[str, int] = defaultdict(int)
        self.collectives: Dict[str, Dict[str, float]] = defaultdict(lambda: defaultdict(float))
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops = 0
        self._shadow = 0
        self._live: Dict[int, int] = {}
        self._axis_of: Dict[str, str] = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axis_of[mesh.get_group(i).group_name] = name

    # -- memory ---------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._live:
            return
        n = s.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def hold(self, tree: Any) -> None:
        """Count ``tree``'s storages as live from now on (until they die)."""
        for t in tensors_of(tree):
            self._track(t)

    # -- collectives ----------------------------------------------------------
    def _axis(self, group: Any) -> str:
        if not isinstance(group, str):
            group = getattr(group, "group_name", None) or str(group)
        if group in self._axis_of:
            return self._axis_of[group]
        from torch.distributed.distributed_c10d import _resolve_process_group
        try:
            return f"span{_resolve_process_group(group).size()}"
        except Exception:  # noqa: BLE001 - a group this rank cannot resolve
            return "unknown"

    # -- dispatch -------------------------------------------------------------
    def __enter__(self):
        # DTensor derives an op's output shape by running it once more at
        # global shapes on fake tensors: no rank runs that, so it is not
        # counted. Without the hook those ops would count too, so a torch
        # that lacks it is refused.
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name, None)
        if orig is None:
            raise RuntimeError(f"StepCounter: this torch has no ShardingPropagator.{name}; "
                               f"DTensor's global-shape metadata ops would be counted")

        def shadow(prop, *a, **kw):
            self._shadow += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                self._shadow -= 1

        setattr(ShardingPropagator, name, shadow)
        self._unpatch = lambda: setattr(ShardingPropagator, name, orig)
        return super().__enter__()

    def __exit__(self, *exc):
        self._unpatch()
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator) or self._shadow:
            return func(*args, **kwargs)
        if func.namespace == "prim":
            return func(*args, **kwargs)      # a fake tensor's metadata query
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented             # DTensor runs it as local ops
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self._track(t)
        ns, _, name = packet._qualified_op_name.partition("::")
        if ns in _NAMESPACES:
            kind = COLLECTIVE_KINDS.get(name.rstrip("_"))
            if kind is not None:
                group = next((a for a in reversed(args)
                              if isinstance(a, str) or hasattr(a, "group_name")
                              or type(a).__name__ == "ScriptObject"), None)
                self.collectives[self._axis(group)][kind] += sum(_nbytes(t) for t in outs)
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if func.is_view or packet in _NO_TRAFFIC:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        n = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += n
        self.bytes_by_op[packet.__name__] += n
        return out


def collective_bytes_by_kind(counter: StepCounter) -> Dict[str, float]:
    """{kind: bytes} over every axis (``hlo.py``'s function of that name
    reads the same sums off HLO text)."""
    out: Dict[str, float] = defaultdict(float)
    for kinds in counter.collectives.values():
        for kind, n in kinds.items():
            out[kind] += n
    return dict(out)


def collective_bytes_by_axis_kind(counter: StepCounter) -> Dict[str, Dict[str, float]]:
    """{axis: {kind: bytes}}: each collective under the mesh dim whose
    group it names (``span<n>`` for a group of several dims)."""
    return {axis: dict(kinds) for axis, kinds in counter.collectives.items()}

"""Lifecycle tracer: store journal events + serve emits -> span trees.

The tracer has two feeds:

* **Store events** — :meth:`Tracer.attach` registers ``on_event`` as a
  store journal hook (``ApiStore.add_journal``). The hook runs under
  the store lock, so it only snapshots ``(clock, type, kind, name,
  conditions)`` into an append-only list; reconstruction is lazy.

* **Emits** — data-plane code that has no store object (serve requests)
  calls the module-level :func:`emit`, which is a no-op unless a tracer
  is installed (same ``install``/``installed`` idiom as ``api/chaos``).

Separately from the tracer, :func:`span` marks the program's own layers
(engine phases, model sub-layers, train-step phases) as ranges named
``knd.<name>`` on the clock of a ``torch.profiler`` profile, beside the
device activity the profile records; outside a profile it costs one
flag read.

:meth:`Tracer.spans` reconstructs per-object span trees:

* claim/workload/node lifecycle — ``submit`` (ADDED) through each
  tracked condition's False->True edge in
  ``Scheduled -> Allocated -> Prepared -> Attached -> Ready`` order.
  A True->False edge (node kill, deallocation) closes the current
  *cycle* and opens a new one at the same instant, so a healed claim
  shows two adjacent span trees — the outage is the seam between them.
* request lifecycle — ``queued -> admitted(prefill) -> first_token
  (decode) -> complete`` from the serve-side emits.

Trees are **gap-free by construction**: each child span starts exactly
where the previous one ended (the first at the root's start), which is
what the tests assert through node-kill heals and chunked
prefill. :func:`chrome_trace` renders spans as Chrome-trace-event JSON
("X" complete events + "M" metadata) loadable in Perfetto or
``chrome://tracing``; :func:`spans_from_store` rebuilds the *final*
cycle offline from a recovered store's condition timestamps (what
``obsctl trace --state-dir`` uses when no live tracer ran).
"""

from __future__ import annotations

import itertools
import json
import sys
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from time import monotonic
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "TRACKED_CONDITIONS", "Span", "Tracer", "emit",
    "install_tracer", "installed_tracer", "active_tracer",
    "chrome_trace", "validate_spans", "spans_from_store",
    "SPAN_PREFIX", "NO_SPAN", "span",
]

# Condition types that advance an object's lifecycle, in canonical
# order (mirrors api.objects.CONDITION_SCHEDULED + PHASE_ORDER without
# importing repro_torch.api — obs must stay import-cycle-free).
TRACKED_CONDITIONS: Tuple[str, ...] = (
    "Scheduled", "Allocated", "Prepared", "Attached", "Ready")

# Request emit vocabulary (serve/engine.py): event -> phase it closes.
REQUEST_EVENTS = ("queued", "admitted", "first_token", "complete", "failed")


@dataclass
class Span:
    """One interval in an object's lifecycle; children tile the parent."""
    kind: str
    obj: str
    name: str
    cat: str
    t0: float
    t1: float
    args: Dict[str, Any] = field(default_factory=dict)
    children: List["Span"] = field(default_factory=list)

    @property
    def duration(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Record store events + emits; reconstruct span trees on demand."""

    def __init__(self, clock=monotonic):
        self.clock = clock
        self._t0 = clock()
        # append-only; list.append is atomic under the GIL and the
        # store hook already runs under the store lock — keep it O(1).
        self._events: List[Tuple[float, str, str, str, Any]] = []
        self._append = self._events.append        # hot-path bound ref
        self._stores: List[Any] = []

    # -- feeds --------------------------------------------------------------

    def on_event(self, ev) -> None:
        """Store journal hook (runs under the store lock — stay cheap).

        Snapshots condition *references*, not (type, status) pairs: the
        store replaces condition objects on every write (``set_condition``
        swaps via ``dataclasses.replace``) but mutates the list in place,
        so a shallow ``tuple(...)`` of the list is a stable snapshot at a
        fraction of the cost — unpacking happens lazily in ``spans()``.
        """
        obj = getattr(ev, "object", None)
        self._append((self.clock(), ev.type, ev.kind, ev.name,
                      tuple(obj.status.conditions) if obj is not None
                      else ()))

    def emit(self, kind: str, name: str, event: str, **args: Any) -> None:
        """Record a point event for an object with no store presence."""
        self._append((self.clock(), "EMIT:" + event, kind, name,
                      args or None))

    def attach(self, store) -> "Tracer":
        store.add_journal(self.on_event)
        self._stores.append(store)
        return self

    def detach(self) -> None:
        for store in self._stores:
            try:
                store.remove_journal(self.on_event)
            except ValueError:
                pass
        self._stores = []

    # -- reconstruction -----------------------------------------------------

    def events(self) -> List[Tuple[float, str, str, str, Any]]:
        return list(self._events)

    def spans(self) -> List[Span]:
        """Per-object span trees (lifecycle cycles + request spans)."""
        by_obj: Dict[Tuple[str, str], List[Tuple[float, str, Any]]] = {}
        for t, typ, kind, name, payload in self._events:
            by_obj.setdefault((kind, name), []).append((t, typ, payload))
        roots: List[Span] = []
        for (kind, name), evs in sorted(by_obj.items()):
            if any(typ.startswith("EMIT:") for _, typ, _ in evs):
                root = _request_spans(kind, name, evs)
                if root is not None:
                    roots.append(root)
            else:
                roots.extend(_lifecycle_spans(kind, name, evs))
        return roots

    # -- export -------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        return chrome_trace(self.spans(), t_origin=self._t0)

    def export(self, path: str) -> str:
        """Write Chrome-trace JSON (Perfetto-loadable); returns path."""
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
            f.write("\n")
        return path


# ---------------------------------------------------------------------------
# Reconstruction helpers
# ---------------------------------------------------------------------------

def _lifecycle_spans(kind: str, name: str,
                     evs: List[Tuple[float, str, Any]]) -> List[Span]:
    """Cycle-segmented condition lifecycle for one store object."""
    t_submit = evs[0][0]
    cycles: List[Dict[str, Any]] = [{"t0": t_submit, "phases": [], "t1": None}]
    status: Dict[str, bool] = {}
    last_t = t_submit
    for t, typ, conds in evs:
        last_t = t
        if typ.startswith("EMIT:") or conds is None:
            continue
        # payload entries are condition objects (live-hook snapshots) or
        # pre-unpacked (type, status) pairs (offline/test feeds)
        now = {}
        for c in conds:
            if type(c) is tuple:
                ct, cs = c
            else:
                ct, cs = c.type, c.status
            now[ct] = cs == "True"
        fell = [c for c in TRACKED_CONDITIONS
                if status.get(c) and not now.get(c, False)]
        if fell:
            cur = cycles[-1]
            cur["t1"] = t
            cycles.append({"t0": t, "phases": [], "t1": None})
        cur = cycles[-1]
        seen = {p for p, _ in cur["phases"]}
        for c in TRACKED_CONDITIONS:
            if now.get(c, False) and not status.get(c, False) and c not in seen:
                cur["phases"].append((c, t))
        status = now
    out: List[Span] = []
    for i, cyc in enumerate(cycles):
        if not cyc["phases"] and cyc["t1"] is None and len(cycles) > 1:
            continue                      # empty trailing cycle
        t_end = cyc["t1"]
        if t_end is None:
            t_end = cyc["phases"][-1][1] if cyc["phases"] else last_t
        root = Span(kind, name, f"{kind}/{name}#cycle{i}", "lifecycle",
                    cyc["t0"], t_end, {"cycle": i})
        prev = cyc["t0"]
        for phase, t in cyc["phases"]:
            root.children.append(
                Span(kind, name, phase, "phase", prev, t))
            prev = t
        if prev < t_end:                  # outage tail up to the fall edge
            root.children.append(
                Span(kind, name, "held", "phase", prev, t_end))
        out.append(root)
    return out


def _request_spans(kind: str, name: str,
                   evs: List[Tuple[float, str, Any]]) -> Optional[Span]:
    """queued -> prefill -> decode span tree from serve emits."""
    ts: Dict[str, float] = {}
    args: Dict[str, Any] = {}
    for t, typ, payload in evs:
        if not typ.startswith("EMIT:"):
            continue
        ev = typ[5:]
        ts.setdefault(ev, t)
        if isinstance(payload, dict):
            args.update(payload)
    t_q = ts.get("queued")
    if t_q is None:
        return None
    t_end = ts.get("complete", ts.get("failed", max(ts.values())))
    root = Span(kind, name, f"{kind}/{name}", "request", t_q, t_end, args)
    t_a = ts.get("admitted")
    t_f = ts.get("first_token")
    prev = t_q
    for phase, t in (("queued", t_a), ("prefill", t_f), ("decode", t_end)):
        if t is None:
            break
        if t < prev:
            t = prev
        root.children.append(Span(kind, name, phase, "request", prev, t))
        prev = t
    if root.children and root.children[-1].t1 < t_end:
        root.children[-1].t1 = t_end
    elif not root.children:
        root.children.append(Span(kind, name, "queued", "request",
                                  t_q, t_end))
    return root


def spans_from_store(store, kinds: Optional[List[str]] = None) -> List[Span]:
    """Offline: rebuild each object's *final* cycle from condition
    ``last_transition`` stamps + ``meta.created`` (monotonic clock)."""
    roots: List[Span] = []
    for obj in store.list_objects():
        kind = (getattr(obj.meta, "kind", "") or type(obj.spec).__name__)
        if kinds and kind not in kinds:
            continue
        created = obj.meta.created
        stamped = [(c.type, c.last_transition)
                   for c in obj.status.conditions
                   if c.type in TRACKED_CONDITIONS and c.status == "True"]
        stamped.sort(key=lambda p: (p[1], TRACKED_CONDITIONS.index(p[0])))
        t_end = max([t for _, t in stamped], default=created)
        root = Span(kind, obj.meta.name, f"{kind}/{obj.meta.name}#final",
                    "lifecycle", created, t_end, {"offline": True})
        prev = created
        for phase, t in stamped:
            if t < prev:
                t = prev
            root.children.append(Span(kind, obj.meta.name, phase, "phase",
                                      prev, t))
            prev = t
        roots.append(root)
    return roots


# ---------------------------------------------------------------------------
# Validation + Chrome trace export
# ---------------------------------------------------------------------------

def validate_spans(roots: List[Span]) -> List[str]:
    """Well-formedness problems ([] == monotonic, nested, gap-free)."""
    problems: List[str] = []
    for root in roots:
        tag = root.name
        if root.t1 < root.t0:
            problems.append(f"{tag}: root not monotonic")
        prev = root.t0
        for ch in root.children:
            if ch.t1 < ch.t0:
                problems.append(f"{tag}/{ch.name}: child not monotonic")
            if ch.t0 != prev:
                problems.append(f"{tag}/{ch.name}: gap ({ch.t0} != {prev})")
            if ch.t0 < root.t0 or ch.t1 > root.t1:
                problems.append(f"{tag}/{ch.name}: escapes root")
            prev = ch.t1
    return problems


def chrome_trace(roots: List[Span],
                 t_origin: Optional[float] = None) -> Dict[str, Any]:
    """Spans -> Chrome trace events ("X" + "M"), ts/dur in µs."""
    if t_origin is None:
        t_origin = min((r.t0 for r in roots), default=0.0)
    pids = {k: i + 1
            for i, k in enumerate(sorted({r.kind for r in roots}))}
    tids: Dict[Tuple[str, str], int] = {}
    events: List[Dict[str, Any]] = []
    for kind, pid in pids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": kind}})
    for root in roots:
        key = (root.kind, root.obj)
        if key not in tids:
            tids[key] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pids[root.kind], "tid": tids[key],
                           "args": {"name": root.obj}})
        pid, tid = pids[root.kind], tids[key]
        for span in [root] + root.children:
            events.append({
                "name": span.name, "cat": span.cat, "ph": "X",
                "ts": round((span.t0 - t_origin) * 1e6, 3),
                "dur": round(max(span.t1 - span.t0, 0.0) * 1e6, 3),
                "pid": pid, "tid": tid,
                "args": dict(span.args),
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ---------------------------------------------------------------------------
# Active tracer (emit() fast path mirrors chaos.sync_point)
# ---------------------------------------------------------------------------

_active: Optional[Tracer] = None
_install_lock = threading.Lock()


def active_tracer() -> Optional[Tracer]:
    return _active


def install_tracer(tracer: Optional[Tracer]) -> None:
    global _active
    with _install_lock:
        _active = tracer


@contextmanager
def installed_tracer(tracer: Tracer) -> Iterator[Tracer]:
    global _active
    with _install_lock:
        prev = _active
        _active = tracer
    try:
        yield tracer
    finally:
        with _install_lock:
            _active = prev


def emit(kind: str, name: str, event: str, **args: Any) -> None:
    """One attribute load + None check when no tracer is installed."""
    t = _active
    if t is not None:
        t.emit(kind, name, event, **args)


# ---------------------------------------------------------------------------
# Program spans on the profiler's clock
# ---------------------------------------------------------------------------

SPAN_PREFIX = "knd."


class _NoSpan:
    """What :func:`span` returns when no profile records: a context that
    does nothing and hands tensors back unmarked."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def inputs(self, *tensors: Any) -> Any:
        return tensors[0] if len(tensors) == 1 else tensors

    def output(self, tensor: Any) -> Any:
        return tensor


NO_SPAN = _NoSpan()

# torch.autograd.profiler once torch is loaded. Its module-level
# ``_is_profiler_enabled`` is True, in every thread, while a
# torch.profiler (or autograd profiler) session records in the process.
_profiler_module: Any = None


def span(name: str) -> Any:
    """A ``knd.<name>`` range around the ``with`` block while a profile
    records; the shared :data:`NO_SPAN` otherwise, after one flag read.

    The range also carries the block's backward: mark the sub-layer's
    inputs with ``s.inputs(...)`` and its output with ``s.output(...)``,
    and ``knd.<name>.bwd`` opens on autograd's thread when the output's
    gradient arrives and closes there when the inputs' gradients are
    complete. The marks are identity autograd nodes, added only while a
    profile records and a gradient is being recorded."""
    mod = _profiler_module or _bind_profiler()
    if mod is None or not mod._is_profiler_enabled:
        return NO_SPAN
    return _Span(name)


def _bind_profiler() -> Any:
    # no import: while torch is not loaded no profile can be recording
    global _profiler_module
    _profiler_module = sys.modules.get("torch.autograd.profiler")
    return _profiler_module


def _range(name: str) -> Any:
    """An unopened profiler range. ``RecordFunctionFast`` records a
    plain CPU op: unlike ``record_function``'s user annotation it gets
    no device-side copy, whose interval would read as device activity,
    and it costs a tenth as much."""
    import torch
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


# Orders the opening of spans and of backward ranges, so that a span
# left by an exception closes the backward ranges opened inside it and
# no older one (a remat recompute inside a backward range stops early
# by raising).
_opened = itertools.count()
_open_backward: Dict[int, "_BackwardRange"] = {}
_open_lock = threading.Lock()


class _Span:
    __slots__ = ("name", "_range", "_seq", "_bwd")

    def __init__(self, name: str):
        self.name = name
        self._range = _range(name)
        self._seq = 0
        self._bwd: Optional[_BackwardRange] = None

    def __enter__(self) -> "_Span":
        self._seq = next(_opened)
        self._range.__enter__()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        if exc_type is not None:
            with _open_lock:
                left = [r for seq, r in _open_backward.items() if seq > self._seq]
            for r in left:
                r.close()
        self._range.__exit__(exc_type, exc, tb)
        return False

    def inputs(self, *tensors: Any) -> Any:
        import torch
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            self._bwd = _BackwardRange(self.name + ".bwd")
            _, close_on_grad = _marks()
            tensors = close_on_grad.apply(self._bwd, *tensors)
        return tensors[0] if len(tensors) == 1 else tensors

    def output(self, tensor: Any) -> Any:
        if self._bwd is None or not tensor.requires_grad:
            return tensor
        open_on_grad, _ = _marks()
        return open_on_grad.apply(self._bwd, tensor)


class _BackwardRange:
    """One sub-layer's backward range: opened by its output's mark,
    closed by its inputs' mark, both on autograd's thread; else when the
    backward pass ends (a pass that needs no gradient of the inputs
    never runs their mark)."""

    __slots__ = ("name", "_range", "_seq")

    def __init__(self, name: str):
        self.name = name
        self._range: Any = None
        self._seq = 0

    def open(self) -> None:
        import torch
        if self._range is not None:
            return
        self._range = _range(self.name)
        self._range.__enter__()
        self._seq = next(_opened)
        with _open_lock:
            _open_backward[self._seq] = self
        torch.autograd.Variable._execution_engine.queue_callback(self.close)

    def close(self) -> None:
        rng, self._range = self._range, None
        if rng is None:
            return
        with _open_lock:
            _open_backward.pop(self._seq, None)
        rng.__exit__(None, None, None)


_mark_functions: Any = None


def _marks() -> Any:
    """The identity autograd functions (open on the output's gradient,
    close on the inputs'), made on first use: this module loads no
    torch."""
    global _mark_functions
    if _mark_functions is None:
        import torch

        class OpenOnGrad(torch.autograd.Function):
            @staticmethod
            def forward(ctx, rng, x):
                ctx.rng = rng
                return x.view_as(x)

            @staticmethod
            def backward(ctx, g):
                ctx.rng.open()
                return None, g

        class CloseOnGrad(torch.autograd.Function):
            @staticmethod
            def forward(ctx, rng, *xs):
                ctx.rng = rng
                return tuple(x.view_as(x) for x in xs)

            @staticmethod
            def backward(ctx, *gs):
                ctx.rng.close()
                return (None,) + gs

        _mark_functions = (OpenOnGrad, CloseOnGrad)
    return _mark_functions

"""Thread-safe metrics registry: labeled counters / gauges / histograms.

Design (docs/OBSERVABILITY.md):

* **Handles** are declared once at module scope with a ``plane_``-prefixed
  literal name and a declared label set::

      _WQ_ENQUEUED = counter("plane_torch_workqueue_enqueued_total",
                             "objects accepted into the dirty queue")

  The global catalog rejects conflicting re-registration; the planelint
  ``metrics-discipline`` pass (``repro.analysis.metrics``, which walks
  all of ``src/``) enforces the module-scope / literal-name /
  declared-labels rules statically.

* **Cells** are per-instance accumulators obtained from a handle at
  component construction time (``handle.cell(arm="baseline")``). A cell
  binds to the registry *active at creation* — the same install/installed
  idiom as ``api/chaos.py`` — so tests isolate instruments by installing
  a fresh registry, while a component's thin-view methods
  (``WorkQueue.telemetry()``, ``ServeEngine.stats()``, ...) stay
  per-instance exact. At export time all cells of
  one ``(instrument, label set)`` aggregate: counters/gauges sum,
  histograms merge.

* A **disabled** registry (``MetricsRegistry(enabled=False)``) hands out
  one shared :data:`NULL_CELL` whose mutators are no-ops — the
  near-zero-overhead path. The port's thin views read plain component
  fields, so they stay exact either way. The process-global default
  registry is enabled, so normal runs always export exact values.

* **Sampled instruments**: a component whose mutations are already
  serialized by an outer lock can count in plain ints and mirror them
  into its cells from a :meth:`MetricsRegistry.add_collect_hook`
  callback — the flush runs when an exporter reads, never on the hot
  path (see ``api/workqueue.py``).

Clocks are injectable (``MetricsRegistry(clock=...)``): histogram
``cell.time()`` context managers and any caller that wants coherent
timing read ``registry.clock``. Nothing in this module imports the rest
of ``repro_torch`` — every plane can instrument itself without cycles.
The catalog is the port's own: nothing here shares state with the JAX
package's registry.
"""

from __future__ import annotations

import json
import math
import threading
import weakref
from bisect import bisect_left as _bisect_left
from contextlib import contextmanager
from time import perf_counter
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

__all__ = [
    "PREFIX", "DEFAULT_BUCKETS", "MAX_LABEL_SETS", "MetricError",
    "InstrumentHandle", "counter", "gauge", "histogram", "catalog",
    "MetricsRegistry", "NULL_CELL", "quantile",
    "active", "install", "installed", "default_registry",
]

PREFIX = "plane_"

# µs-to-tens-of-seconds: covers lease renews (~100µs), reconcile (~ms),
# injected chaos delays, and serve TTFT under load (~s).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# Distinct label sets per instrument per registry. Beyond the cap new
# label sets silently collapse into NULL_CELL (and the registry counts
# the drop) — a cardinality fuse, not a crash.
MAX_LABEL_SETS = 256

_KINDS = ("counter", "gauge", "histogram")


class MetricError(ValueError):
    """Bad instrument declaration or label usage."""


# ---------------------------------------------------------------------------
# Catalog: instrument declarations (process-global, declared once)
# ---------------------------------------------------------------------------

class InstrumentHandle:
    """One declared instrument: name, kind, help text, label names."""

    __slots__ = ("name", "kind", "help", "labels", "buckets")

    def __init__(self, name: str, kind: str, help: str,
                 labels: Tuple[str, ...],
                 buckets: Optional[Tuple[float, ...]]):
        self.name = name
        self.kind = kind
        self.help = help
        self.labels = labels
        self.buckets = buckets

    def signature(self) -> Tuple[Any, ...]:
        return (self.kind, self.labels, self.buckets)

    def cell(self, **labels: str):
        """A per-instance accumulator from the *active* registry."""
        return active().cell(self, labels)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"InstrumentHandle({self.name!r}, {self.kind},"
                f" labels={self.labels})")


_catalog_lock = threading.Lock()
_catalog: Dict[str, InstrumentHandle] = {}


def _register(kind: str, name: str, help: str,
              labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> InstrumentHandle:
    if kind not in _KINDS:
        raise MetricError(f"unknown instrument kind {kind!r}")
    if not isinstance(name, str) or not name.startswith(PREFIX):
        raise MetricError(
            f"instrument name {name!r} must be a str with prefix {PREFIX!r}")
    if not all(isinstance(l, str) for l in labels):
        raise MetricError(f"{name}: label names must be strings: {labels!r}")
    label_t = tuple(labels)
    bucket_t: Optional[Tuple[float, ...]] = None
    if kind == "histogram":
        bucket_t = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bucket_t:
            raise MetricError(f"{name}: histogram needs at least one bucket")
    handle = InstrumentHandle(name, kind, help, label_t, bucket_t)
    with _catalog_lock:
        existing = _catalog.get(name)
        if existing is not None:
            if existing.signature() != handle.signature():
                raise MetricError(
                    f"instrument {name!r} re-registered with a different "
                    f"signature: {existing.signature()} != {handle.signature()}")
            return existing            # idempotent re-import
        _catalog[name] = handle
    return handle


def counter(name: str, help: str, labels: Sequence[str] = ()
            ) -> InstrumentHandle:
    """Declare a monotonically-increasing counter."""
    return _register("counter", name, help, labels)


def gauge(name: str, help: str, labels: Sequence[str] = ()
          ) -> InstrumentHandle:
    """Declare a settable gauge (multiple cells sum at export)."""
    return _register("gauge", name, help, labels)


def histogram(name: str, help: str, labels: Sequence[str] = (),
              buckets: Optional[Sequence[float]] = None) -> InstrumentHandle:
    """Declare a fixed-bucket histogram (count/sum/min/max tracked too)."""
    return _register("histogram", name, help, labels, buckets)


def catalog() -> Dict[str, InstrumentHandle]:
    """Snapshot of every declared instrument (name -> handle)."""
    with _catalog_lock:
        return dict(_catalog)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

class _NullCell:
    """Shared no-op cell handed out by disabled registries.

    One attribute load + one no-op call per instrumented operation —
    the "near-zero overhead when disabled" path.
    """

    __slots__ = ()
    enabled = False
    value = 0.0
    count = 0
    sum = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass

    def dec(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    @contextmanager
    def time(self) -> Iterator[None]:
        yield

    def snapshot(self) -> Dict[str, Any]:
        return {"count": 0, "sum": 0.0}


NULL_CELL = _NullCell()


class CounterCell:
    __slots__ = ("_lock", "_v")
    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        # hot path: raw acquire/release beats the with-statement by ~30%
        lock = self._lock
        lock.acquire()
        try:
            self._v += n
        finally:
            lock.release()

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self._v}


class GaugeCell:
    __slots__ = ("_lock", "_v")
    enabled = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._v -= n

    @property
    def value(self) -> float:
        return self._v

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self._v}


class HistogramCell:
    __slots__ = ("_lock", "_buckets", "_counts", "_count", "_sum",
                 "_min", "_max", "_clock")
    enabled = True

    def __init__(self, buckets: Tuple[float, ...], clock) -> None:
        self._lock = threading.Lock()
        self._buckets = buckets
        self._counts = [0] * (len(buckets) + 1)   # last = +Inf overflow
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._clock = clock

    def observe(self, v: float) -> None:
        # hot path: bucket search outside the lock, total count derived
        # from the per-bucket counts at read time, raw acquire/release
        i = _bisect_left(self._buckets, v)
        lock = self._lock
        lock.acquire()
        try:
            self._counts[i] += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
        finally:
            lock.release()

    @contextmanager
    def time(self) -> Iterator[None]:
        t0 = self._clock()
        try:
            yield
        finally:
            self.observe(self._clock() - t0)

    @property
    def count(self) -> int:
        return sum(self._counts)

    @property
    def sum(self) -> float:
        return self._sum

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counts = list(self._counts)
            count = sum(counts)
            out: Dict[str, Any] = {
                "count": count, "sum": round(self._sum, 9),
                "min": None if count == 0 else self._min,
                "max": None if count == 0 else self._max,
            }
        out["buckets"] = {_le(le): c
                          for le, c in zip(self._buckets, counts)}
        out["buckets"]["+Inf"] = counts[-1]
        return out


def _le(le: float) -> str:
    return f"{le:.6g}"


def quantile(snapshot: Dict[str, Any], q: float) -> float:
    """Approximate quantile from a histogram snapshot (bucket interp,
    clamped to the observed [min, max])."""
    count = snapshot.get("count", 0)
    if not count:
        return 0.0
    target = q * count
    v_min = snapshot.get("min")
    v_max = snapshot.get("max")
    lo = v_min or 0.0
    seen = 0.0
    out = v_max if v_max is not None else lo
    for le_s, c in snapshot["buckets"].items():
        if c == 0:
            continue
        hi = v_max if le_s == "+Inf" else float(le_s)
        if hi is None:
            hi = lo
        if seen + c >= target:
            frac = (target - seen) / c
            out = lo + (hi - lo) * frac
            break
        seen += c
        lo = hi
    if v_max is not None:
        out = min(out, v_max)
    if v_min is not None:
        out = max(out, v_min)
    return out


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


class MetricsRegistry:
    """Holds live cells; exports aggregated Prometheus text / JSON.

    ``enabled=False`` makes :meth:`cell` return the shared
    :data:`NULL_CELL` — instrumented code built under a disabled
    registry pays one no-op call per operation and exports nothing.
    """

    def __init__(self, clock=perf_counter, enabled: bool = True):
        self.clock = clock
        self.enabled = enabled
        self._lock = threading.Lock()
        self._cells: Dict[_LabelKey, List[Any]] = {}
        self._collect_hooks: List[Any] = []        # weak refs
        self.dropped_label_sets = 0

    # -- sampled instruments ------------------------------------------------

    def add_collect_hook(self, fn) -> None:
        """Register a flush callback run at the start of every collect.

        This is the collector-callback pattern for *sampled* instruments:
        a component that is already externally serialized (e.g. the
        workqueue under the plane's reconcile lock) counts in plain ints
        on its hot path and mirrors them into its cells only when an
        exporter actually reads — zero per-operation cell cost. Hooks are
        held weakly (bound methods via ``WeakMethod``) so registering on
        the process-global default registry never pins a component alive.
        """
        try:
            ref: Any = weakref.WeakMethod(fn)
        except TypeError:
            ref = weakref.ref(fn)
        with self._lock:
            self._collect_hooks.append(ref)

    def _run_collect_hooks(self) -> None:
        with self._lock:
            hooks = list(self._collect_hooks)
        live = []
        for wr in hooks:
            fn = wr()
            if fn is None:
                continue
            live.append(wr)
            fn()
        if len(live) != len(hooks):
            with self._lock:
                self._collect_hooks = [
                    w for w in self._collect_hooks
                    if w not in hooks or w in live]

    # -- cell acquisition ---------------------------------------------------

    def cell(self, handle: InstrumentHandle, labels: Dict[str, str]):
        if not self.enabled:
            return NULL_CELL
        if set(labels) != set(handle.labels):
            raise MetricError(
                f"{handle.name}: labels {sorted(labels)} != declared "
                f"{sorted(handle.labels)}")
        key: _LabelKey = (handle.name,
                          tuple((k, str(labels[k])) for k in handle.labels))
        with self._lock:
            bucket = self._cells.get(key)
            if bucket is None:
                distinct = sum(1 for (n, _) in self._cells if n == handle.name)
                if distinct >= MAX_LABEL_SETS:
                    self.dropped_label_sets += 1
                    return NULL_CELL
                bucket = self._cells[key] = []
            if handle.kind == "counter":
                c: Any = CounterCell()
            elif handle.kind == "gauge":
                c = GaugeCell()
            else:
                c = HistogramCell(handle.buckets or DEFAULT_BUCKETS,
                                  self.clock)
            bucket.append(c)
            return c

    # -- aggregation + export ----------------------------------------------

    def collect(self) -> List[Dict[str, Any]]:
        """Aggregated samples: one entry per (instrument, label set)."""
        self._run_collect_hooks()
        cat = catalog()
        with self._lock:
            keys = sorted(self._cells)
            cells = {k: list(v) for k, v in self._cells.items()}
        out: List[Dict[str, Any]] = []
        for name, labelitems in keys:
            handle = cat.get(name)
            if handle is None:       # registered handle always in catalog
                continue
            group = cells[(name, labelitems)]
            sample: Dict[str, Any] = {
                "name": name, "type": handle.kind, "help": handle.help,
                "labels": dict(labelitems),
            }
            if handle.kind in ("counter", "gauge"):
                sample["value"] = round(sum(c.value for c in group), 9)
            else:
                merged: Dict[str, Any] = {"count": 0, "sum": 0.0,
                                          "min": None, "max": None,
                                          "buckets": {}}
                for c in group:
                    snap = c.snapshot()
                    merged["count"] += snap["count"]
                    merged["sum"] = round(merged["sum"] + snap["sum"], 9)
                    for bound in ("min", "max"):
                        v = snap.get(bound)
                        if v is None:
                            continue
                        cur = merged[bound]
                        pick = min if bound == "min" else max
                        merged[bound] = v if cur is None else pick(cur, v)
                    for le, n in snap["buckets"].items():
                        merged["buckets"][le] = merged["buckets"].get(le, 0) + n
                sample.update(merged)
            out.append(sample)
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format (histograms cumulative)."""
        lines: List[str] = []
        last_name = None
        for s in self.collect():
            if s["name"] != last_name:
                lines.append(f"# HELP {s['name']} {s['help']}")
                lines.append(f"# TYPE {s['name']} {s['type']}")
                last_name = s["name"]
            if s["type"] in ("counter", "gauge"):
                lines.append(f"{s['name']}{_labelstr(s['labels'])}"
                             f" {_fmt(s['value'])}")
            else:
                cum = 0
                for le, n in s["buckets"].items():
                    cum += n
                    lab = dict(s["labels"], le=le)
                    lines.append(f"{s['name']}_bucket{_labelstr(lab)} {cum}")
                lines.append(f"{s['name']}_sum{_labelstr(s['labels'])}"
                             f" {_fmt(s['sum'])}")
                lines.append(f"{s['name']}_count{_labelstr(s['labels'])}"
                             f" {s['count']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def to_dict(self) -> Dict[str, Any]:
        """JSON-exporter form: instrument name -> type/help/samples."""
        out: Dict[str, Any] = {}
        for s in self.collect():
            entry = out.setdefault(s["name"], {
                "type": s["type"], "help": s["help"], "samples": []})
            sample = {k: v for k, v in s.items()
                      if k not in ("name", "type", "help")}
            entry["samples"].append(sample)
        return out

    def render_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)


def _labelstr(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels.items())
    return "{" + body + "}"


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


# ---------------------------------------------------------------------------
# Active registry (install/installed idiom, mirrors api/chaos.py)
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()
_active: MetricsRegistry = _DEFAULT


def default_registry() -> MetricsRegistry:
    """The always-enabled process-global registry."""
    return _DEFAULT


def active() -> MetricsRegistry:
    """The registry new cells bind to."""
    return _active


def install(registry: Optional[MetricsRegistry]) -> None:
    """Make ``registry`` active (``None`` restores the default)."""
    global _active
    _active = registry if registry is not None else _DEFAULT


@contextmanager
def installed(registry: MetricsRegistry) -> Iterator[MetricsRegistry]:
    """Scoped :func:`install` — the test/bench isolation idiom."""
    global _active
    prev = _active
    _active = registry
    try:
        yield registry
    finally:
        _active = prev

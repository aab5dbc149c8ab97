"""The program's own spans in a traced run, and the readings they give.

The program opens ``knd.<name>`` ranges (``repro_torch.obs.span``) at
its layers' boundaries while a profile records: the serving engine's
phases (``serve.*``), the model's sub-layers (``model.*``, with
``.bwd`` twins on autograd's thread) and the train step's phases
(``train.*``). This module reduces them beside :mod:`kndbench.trace`,
which reads only the harness's ``kndbench.`` ranges and is left as it
is:

- a range's device time (the program's ranges and, named without their
  prefix, the harness's) is the union, inside the traced window, of the
  intervals of the kernels it launched: those whose launching op (the
  profiler links each kernel to the innermost op open at its launch)
  ran on the range's own thread, between its start and its end, nested
  ranges included; a kernel launched outside every range counts
  nowhere, and one launched on another thread does not count under a
  range that merely overlaps it in time;
- its host time is the summed length of its calls inside the window;
- the idle gaps between busy intervals are labelled by the innermost
  range of either prefix open at the gap's middle.

:func:`reduce_program` works on plain event lists, so that the tests can
feed it; :func:`summarize_program` takes them from a finished
``torch.profiler`` profile. :func:`readings` gives the per-layer
metrics that read the program's spans.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kndbench.trace import PREFIX as HARNESS, _merge

PROGRAM = "knd."

# (full name, thread, start, end); times in microseconds
Range = Tuple[str, int, float, float]
# (launching thread or None, launch time or None, start, end)
Kernel = Tuple[Optional[int], Optional[float], float, float]


@dataclass
class ProgramSummary:
    window_s: float
    busy_s: float
    device_s: Dict[str, float] = field(default_factory=dict)
    host_s: Dict[str, float] = field(default_factory=dict)
    calls: Dict[str, int] = field(default_factory=dict)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    intervals: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict, repr=False)

    def device_union_s(self, *names: str) -> float:
        """Device seconds under any of ``names``, each interval once."""
        ivs = [iv for n in names for iv in self.intervals.get(n, [])]
        return sum(e - s for s, e in _merge(ivs)) * 1e-6


def _label(name: str) -> str:
    return name[len(HARNESS):] if name.startswith(HARNESS) else name[len(PROGRAM):]


def reduce_program(ranges: List[Range], kernels: List[Kernel]) -> ProgramSummary:
    """The program's readings from plain event lists: ``ranges`` of both
    prefixes, the traced window (``kndbench.window``) among them, and
    every device activity in ``kernels``."""
    win = [(s, e) for n, _, s, e in ranges if n == HARNESS + "window"]
    if not win:
        raise RuntimeError("the trace holds no kndbench.window range")
    w0, w1 = win[0]

    def clip(s: float, e: float) -> Optional[Tuple[float, float]]:
        s, e = max(s, w0), min(e, w1)
        return (s, e) if e > s else None

    busy = _merge([iv for iv in (clip(s, e) for _, _, s, e in kernels) if iv])
    by_thread: Dict[int, List[Tuple[float, float, float]]] = defaultdict(list)
    for th, t, s, e in kernels:
        if th is not None and t is not None:
            by_thread[th].append((t, s, e))
    for ks in by_thread.values():
        ks.sort()
    launch_t = {th: [k[0] for k in ks] for th, ks in by_thread.items()}

    own: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    host: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    for n, th, s, e in ranges:
        if n == HARNESS + "window" or e < w0 or s > w1:
            continue
        name = _label(n)
        if s >= w0 and e <= w1:
            calls[name] += 1
        host[name] += min(e, w1) - max(s, w0)
        ks = by_thread.get(th, [])
        lo = bisect.bisect_left(launch_t.get(th, []), s)
        hi = bisect.bisect_right(launch_t.get(th, []), e)
        own[name].extend(iv for iv in (clip(ks_, ke) for _, ks_, ke in ks[lo:hi]) if iv)
    intervals = {name: _merge(ivs) for name, ivs in own.items()}

    inner = sorted((e - s, _label(n), s, e) for n, _, s, e in ranges
                   if n != HARNESS + "window")
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = next((n for _, n, s, e in inner if s <= mid <= e), "outside_spans")
        gaps[label] += (b - a) * 1e-6
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:16]
    return ProgramSummary(
        window_s=(w1 - w0) * 1e-6, busy_s=sum(e - s for s, e in busy) * 1e-6,
        device_s={n: sum(e - s for s, e in ivs) * 1e-6 for n, ivs in intervals.items()},
        host_s={n: v * 1e-6 for n, v in host.items()}, calls=dict(calls),
        idle_gaps=[[n, v] for n, v in top_gaps], intervals=intervals)


def profile_events(prof) -> Tuple[List[Range], List[Kernel]]:
    """The event lists of a finished ``torch.profiler.profile`` (CPU and
    CUDA activity). A kernel's ``linked_correlation_id`` is the
    correlation id of the op that launched it, the innermost one open at
    its launch. The CUDA runtime's and driver's calls (``cuda*``,
    ``cu*``) are CPU events with ids of another count, and a range's
    device-side copy is no kernel."""
    import torch
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ops: Dict[int, Tuple[int, float]] = {}
    ranges: List[Range] = []
    device = []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns() * 1e-3
        ours = name.startswith(PROGRAM) or name.startswith(HARNESS)
        if e.device_type() == cpu and not name.startswith("cu"):
            ops[e.correlation_id()] = (e.start_thread_id(), start)
            if ours:
                ranges.append((name, e.start_thread_id(), start, start + e.duration_ns() * 1e-3))
        elif e.device_type() == cuda and not ours:
            device.append((e.linked_correlation_id(), start, start + e.duration_ns() * 1e-3))
    kernels = [ops.get(link, (None, None)) + (s, e) for link, s, e in device]
    return ranges, kernels


def summarize_program(prof) -> ProgramSummary:
    return reduce_program(*profile_events(prof))


def _share(s: ProgramSummary, *names: str) -> Optional[float]:
    dev = s.device_union_s(*names)
    return dev / s.busy_s if s.busy_s > 0 and dev > 0 else None


def readings(s: ProgramSummary) -> Dict[str, Optional[float]]:
    """The per-layer metrics that read the program's spans; None where
    the trace holds nothing to read (no kernels on the CPU, no engine
    tick in a training run)."""
    ticks = s.calls.get("serve.model", 0)
    engine = sum(s.host_s.get(n, 0.0) for n in ("serve.admit", "serve.feed", "serve.sample"))
    return {
        "attention_device_share.serve": _share(s, "model.attention") if ticks else None,
        "engine_host_ms.serve": 1e3 * engine / ticks if ticks else None,
        "attention_device_share.train":
            None if ticks else _share(s, "model.attention", "model.attention.bwd"),
        "ssd_scan_device_share.train":
            None if ticks else _share(s, "model.ssd.scan", "model.ssd.scan.bwd"),
    }

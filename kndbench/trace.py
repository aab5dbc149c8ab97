"""Spans and the reduction of a device trace to the benchmark's readings.

Spans are the benchmark's own: ``torch.profiler.record_function`` ranges
named ``kndbench.<name>``, opened by the harness around its calls into the
program and, in a traced run, around the callables the program looks up
at run time (:func:`wrap`). Outside a traced run no span is opened.

The reduction reads ``torch.profiler``'s events (CUDA activity through
CUPTI): the device's busy time is the union of its kernel, copy and set
intervals inside the traced window (the ``kndbench.window`` range), not
their sum; a span's device time is the device time of the kernels
launched under it, on whatever thread it ran; the idle gaps between busy
intervals are labelled by the innermost span open on the host at the
gap's middle.
"""

from __future__ import annotations

import contextlib
import functools
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

PREFIX = "kndbench."


class Spans:
    """Opens ``kndbench.<name>`` ranges when tracing, nothing otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function(PREFIX + name)


def wrap(owner: Any, attr: str, span: str, record: Optional[Callable] = None) -> Callable:
    """Replace ``owner.attr`` by a wrapper that opens the span ``span`` and,
    with ``record``, passes it the call's arguments first. Returns a
    function that puts the original back."""
    import torch
    orig = getattr(owner, attr)

    @functools.wraps(orig)
    def wrapper(*args, **kwargs):
        if record is not None:
            record(*args, **kwargs)
        with torch.profiler.record_function(PREFIX + span):
            return orig(*args, **kwargs)

    setattr(owner, attr, wrapper)
    return lambda: setattr(owner, attr, orig)


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    span_device_s: Dict[str, float] = field(default_factory=dict)
    span_calls: Dict[str, int] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    kernels: int = 0


def _device_total(e) -> float:
    v = getattr(e, "device_time_total", None)
    return float(v if v is not None else e.cuda_time_total)


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce_events(cpu_ranges: List[Tuple[str, float, float, float]],
                  device: List[Tuple[str, float, float]]) -> TraceSummary:
    """The readings from plain event lists, times in microseconds:
    ``cpu_ranges`` are (span name without prefix, start, end, device time
    under it) and ``device`` (name, start, end) of every device activity."""
    win = [(s, e) for n, s, e, _ in cpu_ranges if n == "window"]
    if not win:
        raise RuntimeError("the trace holds no kndbench.window range")
    w0, w1 = win[0]
    clipped = [(max(s, w0), min(e, w1)) for _, s, e in device if e > w0 and s < w1]
    busy = _merge([iv for iv in clipped if iv[1] > iv[0]])
    busy_us = sum(e - s for s, e in busy)
    per_span: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    for n, s, e, dev in cpu_ranges:
        if n != "window" and s >= w0 and e <= w1:
            per_span[n] += dev * 1e-6
            calls[n] += 1
    ops: Dict[str, float] = defaultdict(float)
    for n, s, e in device:
        if e > w0 and s < w1:
            ops[n] += (min(e, w1) - max(s, w0)) * 1e-6
    host = sorted((e - s, n, s, e) for n, s, e, _ in cpu_ranges if n != "window")
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = next((n for _, n, s, e in host if s <= mid <= e), "outside_spans")
        gaps[label] += (b - a) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                        span_device_s=dict(per_span), span_calls=dict(calls),
                        device_ops=[[n, v] for n, v in top],
                        idle_gaps=[[n, v] for n, v in top_gaps], kernels=len(device))


def summarize(prof) -> TraceSummary:
    """Reduce a finished ``torch.profiler.profile`` (CPU and CUDA activity)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    cpu_ranges, device = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == cuda:
            if not e.name.startswith(PREFIX):      # the ranges' device-side copies
                device.append((e.name, float(tr.start), float(tr.end)))
        elif e.name.startswith(PREFIX):
            cpu_ranges.append((e.name[len(PREFIX):], float(tr.start), float(tr.end),
                               _device_total(e)))
    return reduce_events(cpu_ranges, device)


@contextlib.contextmanager
def profiled(enabled: bool, out: Dict[str, Any]):
    """Profile the block with CPU and CUDA activity when ``enabled``; the
    block opens the ``kndbench.window`` range itself. The profile is kept
    in ``out["prof"]``: reduce it with :func:`finish` once the measured
    window has closed, since the reduction takes longer than the block."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    out["prof"] = prof


def finish(out: Dict[str, Any]) -> Optional[TraceSummary]:
    """The summary of the profile :func:`profiled` kept, or None."""
    prof = out.pop("prof", None)
    return None if prof is None else summarize(prof)

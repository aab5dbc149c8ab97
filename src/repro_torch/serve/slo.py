"""SloTracker: per-arm serving telemetry (request latency, TTFT, TPOT).

Requests are observed per *arm* ("baseline" or "canary", the rollout
revision a replica serves); aggregates are exact and order-insensitive
(nearest-rank percentiles over the retained window), so a pinned
request trace always produces the same snapshot.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional

if TYPE_CHECKING:  # pragma: no cover - typing only
    from .engine import Request

__all__ = ["SloTracker"]


def _pct(samples: List[float], q: float) -> float:
    """Deterministic percentile: nearest-rank over the sorted samples."""
    ordered = sorted(samples)
    return ordered[int(q * (len(ordered) - 1))]


def _p95(samples: List[float]) -> float:
    return _pct(samples, 0.95)


class SloTracker:
    """Accumulates per-arm observations into deterministic snapshots."""

    def __init__(self, window: int = 256) -> None:
        self.window = window
        self._latencies: Dict[str, List[float]] = {}
        self._ttfts: Dict[str, List[float]] = {}
        self._tpots: Dict[str, List[float]] = {}
        self._errors: Dict[str, int] = {}
        self._totals: Dict[str, int] = {}

    def _push(self, store: Dict[str, List[float]], arm: str,
              value: float) -> None:
        vals = store.setdefault(arm, [])
        vals.append(float(value))
        if len(vals) > self.window:
            del vals[:len(vals) - self.window]

    def observe(self, arm: str, latency_ms: float, error: bool = False, *,
                ttft_ms: Optional[float] = None,
                tpot_ms: Optional[float] = None) -> None:
        self._push(self._latencies, arm, latency_ms)
        if ttft_ms is not None:
            self._push(self._ttfts, arm, ttft_ms)
        if tpot_ms is not None:
            self._push(self._tpots, arm, tpot_ms)
        self._totals[arm] = self._totals.get(arm, 0) + 1
        if error:
            self._errors[arm] = self._errors.get(arm, 0) + 1

    def observe_request(self, arm: str, request: "Request") -> None:
        """Ingest one terminal request's measured latencies."""
        lat = request.latency_s
        self.observe(
            arm,
            0.0 if lat is None else lat * 1e3,
            error=request.failed,
            ttft_ms=None if request.ttft_s is None else request.ttft_s * 1e3,
            tpot_ms=None if request.tpot_s is None else request.tpot_s * 1e3)

    def arm_snapshot(self, arm: str) -> Dict[str, float]:
        total = self._totals.get(arm, 0)
        lat = self._latencies.get(arm, [])
        ttft = self._ttfts.get(arm, [])
        tpot = self._tpots.get(arm, [])
        return {
            "samples": total,
            "p95_latency_ms": _p95(lat) if lat else 0.0,
            "p50_latency_ms": _pct(lat, 0.5) if lat else 0.0,
            "p95_ttft_ms": _p95(ttft) if ttft else 0.0,
            "p50_ttft_ms": _pct(ttft, 0.5) if ttft else 0.0,
            "p95_tpot_ms": _p95(tpot) if tpot else 0.0,
            "p50_tpot_ms": _pct(tpot, 0.5) if tpot else 0.0,
            "error_rate": (self._errors.get(arm, 0) / total) if total else 0.0,
        }

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {arm: self.arm_snapshot(arm) for arm in sorted(self._totals)}

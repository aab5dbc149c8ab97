"""Analytic collective-performance model (the container has no real NICs).

The port's own copy of the JAX package's ``topology/netsim.py`` (that
module imports no JAX, but the port imports nothing of that package):
the same calibrated knots, alphas and plateaus, and ``run_lottery``
draws from ``random.Random(seed)`` in the same order, so its samples
are JAX's bit for bit. Two halves:

1. **NCCL/RoCE model** — reproduces the paper's Tables II/III. An
   alpha-beta model per collective with a size-dependent transport
   efficiency curve e(S) (log-interpolated knots) and hard DMA-path
   plateaus per topology tier (same-switch / same-socket / cross-socket,
   from `gcp.dma_path_bw`). Free parameters are calibrated ONCE against
   the paper's *aligned* arm (three sizes per collective); the *unaligned*
   arm — the paper's headline result — is then a genuine prediction of
   the lottery over DMA tiers.

2. **TPU ICI/DCN model** — ring collectives over mesh axes with
   *placement hop-dilation*: a logical ring whose neighbors sit d hops
   apart on the torus serializes d link traversals per step, so time
   scales by mean(d) (bandwidth) and alpha by max(d) (latency). Aligned
   planner placements give d == 1; legacy random placements give
   d ~ X/4 + Y/4 (~8 on a 16x16 torus). The node scheduler scores
   placements with it.

Bandwidths GB/s; sizes bytes; times seconds.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .fabric import Fabric
from .gcp import A4Node, NIC_BW, dma_path_bw
from .tpu import DCN_HOST_BW, ICI_BW, ICI_LAT, TpuCluster

__all__ = [
    "EfficiencyCurve", "NcclModel", "LotteryResult",
    "run_lottery", "ring_collective_time", "axis_collective_seconds",
]


# ---------------------------------------------------------------------------
# Size-dependent transport efficiency
# ---------------------------------------------------------------------------


@dataclass
class EfficiencyCurve:
    """e(S): piecewise log-linear between (size, efficiency) knots."""

    knots: List[Tuple[float, float]]  # (bytes, efficiency), sorted by bytes

    def __post_init__(self) -> None:
        self.knots = sorted(self.knots)

    def __call__(self, size: float) -> float:
        ks = self.knots
        if size <= ks[0][0]:
            return ks[0][1]
        if size >= ks[-1][0]:
            return ks[-1][1]
        for (s0, e0), (s1, e1) in zip(ks, ks[1:]):
            if s0 <= size <= s1:
                f = (math.log(size) - math.log(s0)) / (math.log(s1) - math.log(s0))
                return e0 + f * (e1 - e0)
        return ks[-1][1]  # unreachable


# ---------------------------------------------------------------------------
# NCCL over RoCE (the paper's experiment)
# ---------------------------------------------------------------------------


@dataclass
class NcclModel:
    """2-node NCCL ring collectives gated by each rank's GPU->NIC DMA path.

    Calibration (fit on the ALIGNED arm only, benchmarks/calibrate.py):
    alpha per collective, e(S) knots per collective, and the two
    misaligned-tier plateaus. Structure (which GPU/NIC pairs fall in
    which tier) comes from the fabric graph, not from fitting.
    """

    fabric: Fabric
    # DMA plateau bandwidth per tier (tier 0 exceeds NIC line rate).
    # Calibrated 2026-07 against Tables II/III (see EXPERIMENTS.md
    # §Calibration): aligned cells are fit exactly by construction; the
    # unaligned cells are lottery predictions.
    tier_bw: Tuple[float, float, float] = (64.0, 40.0, 27.5)
    nic_bw: float = NIC_BW
    alpha: Dict[str, float] = field(default_factory=lambda: {
        "all_gather": 18.0e-6, "all_reduce": 14.0e-6})
    curves: Dict[str, EfficiencyCurve] = field(default_factory=lambda: {
        "all_gather": EfficiencyCurve([(65536, 0.1024), (1 << 20, 0.3897), (8 << 30, 0.9320)]),
        "all_reduce": EfficiencyCurve([(65536, 0.1021), (1 << 20, 0.4732), (8 << 30, 0.9388)]),
    })
    # DMA-plateau size-efficiency exponent per collective: the plateau is
    # multiplied by e(S)**gamma (gamma<1 -> misaligned paths suffer less
    # at small sizes, where latency dominates over the P2P bottleneck).
    dma_gamma: Dict[str, float] = field(default_factory=lambda: {
        "all_gather": 0.8, "all_reduce": 1.0})
    hop_latency: float = 0.2e-6  # extra alpha per DMA path tier step

    def rank_path(self, gpu: str, nic: str) -> Tuple[float, float, int]:
        # The graph decides WHICH tier a (gpu, nic) pair falls in; the
        # calibrated plateau decides the tier's effective bandwidth. (The
        # raw link bandwidths in the graph are line rates; sustained P2P
        # throughput through root/UPI is what the plateaus capture.)
        _, lat, tier = dma_path_bw(self.fabric, gpu, nic)
        return self.tier_bw[tier], lat, tier

    def effective_bw(self, size: float, collective: str,
                     ranks: Sequence[Tuple[str, str]]) -> Tuple[float, float]:
        """(bottleneck effective bandwidth, extra path latency) across ranks.

        Each rank's path is gated by the slower of (a) the NIC transport
        at NCCL's size-dependent efficiency and (b) the GPU->NIC DMA
        plateau of its topology tier.
        """
        e = self.curves[collective](size)
        gamma = self.dma_gamma[collective]
        bws, lats = [], []
        for gpu, nic in ranks:
            dma_bw, lat, tier = self.rank_path(gpu, nic)
            eff = min(self.nic_bw * e, dma_bw * (e ** gamma))
            bws.append(eff * 1e9)
            lats.append(lat + tier * self.hop_latency)
        return min(bws), max(lats)

    # -- collectives (n ranks, ring algorithm, nccl-tests busbw convention) --
    def all_gather_time(self, size: float, ranks: Sequence[Tuple[str, str]]) -> float:
        n = len(ranks)
        bw, extra = self.effective_bw(size, "all_gather", ranks)
        steps = n - 1
        return steps * (self.alpha["all_gather"] + extra) + steps * (size / n) / bw

    def all_reduce_time(self, size: float, ranks: Sequence[Tuple[str, str]]) -> float:
        n = len(ranks)
        bw, extra = self.effective_bw(size, "all_reduce", ranks)
        steps = 2 * (n - 1)
        return steps * (self.alpha["all_reduce"] + extra) + steps * (size / n) / bw

    def busbw(self, collective: str, size: float,
              ranks: Sequence[Tuple[str, str]]) -> float:
        """nccl-tests bus bandwidth in GB/s."""
        n = len(ranks)
        if collective == "all_gather":
            t = self.all_gather_time(size, ranks)
            algbw = size / t
            return algbw * (n - 1) / n / 1e9
        if collective == "all_reduce":
            t = self.all_reduce_time(size, ranks)
            algbw = size / t
            return algbw * 2 * (n - 1) / n / 1e9
        raise ValueError(f"unknown collective {collective!r}")


@dataclass
class LotteryResult:
    mean: float
    std: float
    samples: List[float]

    @staticmethod
    def of(samples: List[float]) -> "LotteryResult":
        n = len(samples)
        mean = sum(samples) / n
        var = sum((s - mean) ** 2 for s in samples) / (n - 1 if n > 1 else 1)
        return LotteryResult(mean, math.sqrt(var), samples)


def run_lottery(model: NcclModel, nodes: Sequence[A4Node], collective: str,
                size: float, trials: int = 100, aligned: bool = False,
                seed: int = 0, jitter: float = 0.001) -> LotteryResult:
    """The paper's experiment: ``trials`` StatefulSet deployments.

    aligned=True  -> DRA CEL selector pins GPU i + NIC i (same PCI root).
    aligned=False -> NIC fixed by ResourceClaim; GPU drawn by the legacy
                     device plugin uniformly at random per node (SV.A.2).
    ``jitter`` models run-to-run measurement noise (fraction of mean).
    """
    rng = random.Random(seed)
    samples = []
    for _ in range(trials):
        ranks = []
        for node in nodes:
            nic_idx = 0  # the claim requests a specific RDMA NIC
            gpu_idx = nic_idx if aligned else rng.randrange(len(node.gpus))
            ranks.append((node.gpus[gpu_idx], node.nics[nic_idx]))
        bw = model.busbw(collective, size, ranks)
        bw *= 1.0 + rng.gauss(0.0, jitter)
        samples.append(bw)
    return LotteryResult.of(samples)


# ---------------------------------------------------------------------------
# TPU ICI ring collectives with placement dilation
# ---------------------------------------------------------------------------


def ring_collective_time(collective: str, size: float, axis_size: int,
                         link_bw_gbs: float = ICI_BW,
                         dilation_mean: float = 1.0,
                         dilation_max: int = 1,
                         alpha: float = ICI_LAT,
                         bidirectional: bool = True) -> float:
    """Time for one collective over a mesh axis of ``axis_size`` ranks.

    ``size`` is the FULL logical payload (e.g. the gathered array bytes
    for all_gather, the reduced array bytes for all_reduce).
    Bidirectional ICI rings stream both directions -> 2x link bandwidth.
    Dilated placements multiply the beta term by mean hop distance (link
    serialization) and the alpha term by max hop distance.
    """
    n = axis_size
    if n <= 1:
        return 0.0
    bw = link_bw_gbs * 1e9 * (2.0 if bidirectional else 1.0)
    shard = size / n
    if collective in ("all_gather", "reduce_scatter"):
        steps = n - 1
        payload = steps * shard
    elif collective == "all_reduce":
        steps = 2 * (n - 1)
        payload = steps * shard
    elif collective == "all_to_all":
        # ring all-to-all: each rank forwards (n-1)/2 shards on average
        steps = n - 1
        payload = size * (n - 1) / (2 * n)
    elif collective == "collective_permute":
        steps = 1
        payload = size
    else:
        raise ValueError(f"unknown collective {collective!r}")
    return steps * alpha * dilation_max + payload * dilation_mean / bw


def axis_collective_seconds(per_collective_bytes: Dict[str, float],
                            axis_size: int,
                            link_bw_gbs: float,
                            dilation_mean: float = 1.0,
                            dilation_max: int = 1) -> float:
    """Sum collective time over a dict of {collective kind: total bytes}."""
    total = 0.0
    for kind, size in per_collective_bytes.items():
        total += ring_collective_time(kind, size, axis_size, link_bw_gbs,
                                      dilation_mean, dilation_max)
    return total


def random_permutation_dilation(cluster: TpuCluster, pod: int,
                                axis_size: int, trials: int = 32,
                                seed: int = 0) -> Tuple[float, int]:
    """Expected (mean, max) hop dilation of a ring over ``axis_size`` chips
    drawn uniformly from the pod — the device-plugin-style placement."""
    from .tpu import ring_dilation
    rng = random.Random(seed)
    chips = cluster.all_chips(pod)
    means, maxes = [], []
    for _ in range(trials):
        ring = rng.sample(chips, axis_size)
        m, mx = ring_dilation(cluster, ring)
        means.append(m)
        maxes.append(mx)
    return sum(means) / len(means), max(maxes)

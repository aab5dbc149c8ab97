"""Pod/job startup pipelines: CNI vs CNI+DevicePlugin vs KND (Figs. 2-4).

Reproduces Table I (KND pod startup latency percentiles) and quantifies
the architectural critique of §II:

* the CNI path calls back to the API server from the pod-critical path
  (the shim-binary -> daemon -> apiserver loop in Fig. 2) and carries a
  daemon-liveness hazard ("if the daemon process is restarting or has
  crashed, the operation will fail after a lengthy timeout");
* the CNI+DevicePlugin path (Fig. 3) adds the meta-plugin chain and
  annotation-passing between uncoordinated components;
* the KND path (Fig. 4) moves slow work to NodePrepareResources *before*
  the critical phase and pushes config with the claim, so the startup
  path is hook dispatch only.

Latency model: each step is lognormal(median, sigma). The KND arm is
calibrated to Table I (P50 = 1.8 s, P90 = 2.1 s, P99 = 2.3 s); the legacy
arms reuse the SAME shared-step distributions and add only their extra
architectural steps, so the comparison isolates architecture, not tuning.
Step medians for the extra steps follow the paper's qualitative claims
(documented inline); absolute legacy numbers are model assumptions and
are labelled as such in EXPERIMENTS.md.

The port's own copy of the JAX package's ``core/lifecycle.py`` (pure
Python; the port imports nothing of that package).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["Step", "Pipeline", "cni_pipeline", "cni_device_plugin_pipeline",
           "knd_pipeline", "simulate", "percentiles", "STARTUP_ARMS"]


@dataclass(frozen=True)
class Step:
    name: str
    median_s: float
    sigma: float = 0.10
    # probability this step stalls (daemon restart, apiserver retry), and
    # the extra stall time if it does
    hazard_p: float = 0.0
    hazard_extra_s: float = 0.0
    critical_path: bool = True   # NodePrepareResources runs off-path
    parallel_group: Optional[str] = None  # NRI hooks in one group overlap

    def sample(self, rng: random.Random) -> float:
        v = self.median_s * math.exp(rng.gauss(0.0, self.sigma))
        if self.hazard_p > 0 and rng.random() < self.hazard_p:
            v += self.hazard_extra_s * (0.75 + 0.5 * rng.random())
        return v


@dataclass
class Pipeline:
    name: str
    steps: List[Step]
    components: List[str]         # independent moving parts (Fig. 5 vs 6)
    apiserver_calls_on_path: int  # control-plane round-trips during startup

    def sample_total(self, rng: random.Random) -> float:
        total = 0.0
        groups: Dict[str, float] = {}
        for s in self.steps:
            if not s.critical_path:
                continue
            v = s.sample(rng)
            if s.parallel_group:
                groups[s.parallel_group] = max(groups.get(s.parallel_group, 0.0), v)
            else:
                total += v
        return total + sum(groups.values())

    @property
    def critical_steps(self) -> int:
        seen_groups = set()
        n = 0
        for s in self.steps:
            if not s.critical_path:
                continue
            if s.parallel_group:
                if s.parallel_group not in seen_groups:
                    seen_groups.add(s.parallel_group)
                    n += 1
            else:
                n += 1
        return n


# Shared steps (identical distributions across all three arms)
_SCHEDULE = Step("scheduler-bind", 0.306, 0.276)
_KUBELET = Step("kubelet-sync", 0.198, 0.23)
_SANDBOX = Step("runtime-create-sandbox", 0.45, 0.23)
_IMAGE = Step("image-ready-check", 0.162, 0.345)
_START = Step("start-containers", 0.378, 0.23)

# Control-plane RTT for one API-server lookup from a node agent
_API_RTT = 0.055


def cni_pipeline() -> Pipeline:
    """Fig. 2: shim CNI binary delegating to a long-running daemon."""
    return Pipeline(
        name="cni",
        components=["cni-shim-binary", "cni-daemon"],
        apiserver_calls_on_path=2,
        steps=[
            _SCHEDULE, _KUBELET, _SANDBOX, _IMAGE,
            Step("cni-add-exec", 0.06, 0.20),
            # shim -> daemon IPC; hazard: "if the daemon process is
            # restarting or has crashed, the operation will fail after a
            # lengthy timeout" -> CNI timeout + kubelet retry
            Step("daemon-ipc", 0.05, 0.20, hazard_p=0.02, hazard_extra_s=9.0),
            Step("daemon-apiserver-lookup", 2 * _API_RTT, 0.25,
                 hazard_p=0.01, hazard_extra_s=1.0),
            Step("netns-configure", 0.16, 0.15),
            _START,
        ])


def cni_device_plugin_pipeline() -> Pipeline:
    """Fig. 3: Multus + SR-IOV device plugin + RDMA CNI (three components)."""
    return Pipeline(
        name="cni+device-plugin",
        components=["multus", "sriov-device-plugin", "rdma-cni", "cni-daemon"],
        apiserver_calls_on_path=4,
        steps=[
            _SCHEDULE,
            Step("device-plugin-allocate", 0.12, 0.15),
            _KUBELET, _SANDBOX, _IMAGE,
            Step("multus-add-exec", 0.07, 0.20),
            Step("multus-apiserver-net-attach-def", 2 * _API_RTT, 0.25,
                 hazard_p=0.01, hazard_extra_s=1.0),
            Step("primary-cni-delegate", 0.10, 0.20,
                 hazard_p=0.02, hazard_extra_s=9.0),
            # state passed via annotations between DP and CNI (§II: "no
            # native synchronization ... rely on passing state through
            # annotations"): another read + occasional not-yet-written retry
            Step("rdma-cni-annotation-read", 2 * _API_RTT, 0.25,
                 hazard_p=0.05, hazard_extra_s=2.0),
            Step("rdma-netns-configure", 0.16, 0.15),
            _START,
        ])


def knd_pipeline() -> Pipeline:
    """Fig. 4: DRA prepare off the critical path + parallel NRI hooks."""
    return Pipeline(
        name="knd",
        components=["tpu-dra-driver", "dranet"],
        apiserver_calls_on_path=0,
        steps=[
            _SCHEDULE, _KUBELET,
            # NodePrepareResources: "slow setup operations before the
            # pod's critical startup phase" — config was pushed with the
            # claim, no callback. Modeled off-path.
            Step("node-prepare-resources", 0.36, 0.46, critical_path=False),
            _SANDBOX, _IMAGE,
            # NRI hooks: independent drivers act in parallel
            Step("nri-runpodsandbox-dranet", 0.153, 0.345, parallel_group="sandbox-hooks"),
            Step("nri-runpodsandbox-tpu", 0.108, 0.345, parallel_group="sandbox-hooks"),
            Step("nri-createcontainer-hooks", 0.099, 0.345),
            _START,
        ])


STARTUP_ARMS = {
    "cni": cni_pipeline,
    "cni+device-plugin": cni_device_plugin_pipeline,
    "knd": knd_pipeline,
}


def simulate(pipeline: Pipeline, trials: int = 100, seed: int = 0) -> List[float]:
    rng = random.Random(seed)
    return [pipeline.sample_total(rng) for _ in range(trials)]


def percentiles(samples: Sequence[float],
                ps: Sequence[float] = (50, 90, 99)) -> Dict[float, float]:
    xs = sorted(samples)
    out = {}
    for p in ps:
        k = (len(xs) - 1) * p / 100.0
        lo, hi = int(math.floor(k)), int(math.ceil(k))
        out[p] = xs[lo] if lo == hi else xs[lo] + (k - lo) * (xs[hi] - xs[lo])
    return out

"""Shared test fixtures: the standard control-plane cluster.

Every control-plane test file used to hand-roll the same setup (TPU
cluster -> DriverRegistry -> ControlPlane -> run_discovery, plus a
chip-claim builder). That lives here now, both as plain importable
helpers (``from conftest import make_tpu_plane, chip_claim`` — usable
from non-fixture contexts like parametrize and the chaos harness in
``tests/chaos.py``) and as thin fixtures.

Also configures the suite-wide safety rails:

* the ``slow`` marker (subprocess + SIGKILL tests; deselect with
  ``-m "not slow"``);
* a **global deadlock guard**: with ``PYTEST_GLOBAL_TIMEOUT=<seconds>``
  in the environment (scripts/ci.sh sets it), a run that exceeds the
  budget dumps every thread's stack via ``faulthandler`` and hard-exits
  — a deadlocked informer fails the gate fast instead of hanging it.
"""

import faulthandler
import os
import sys

# Keep the default test process single-device (the dry-run sets its own
# 512-device flag in a dedicated process; multi-device tests subprocess).
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import pytest

from repro.api import ControlPlane
from repro.core import (ClaimSpec, DeviceRequest, DriverRegistry, IciDriver,
                        ResourceClaim, TpuDriver)
from repro.topology.tpu import TpuPodSpec, build_tpu_cluster


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running subprocess/SIGKILL tests; skip with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (hand-written kernels have no CPU mode); "
        "skips without one")
    budget = os.environ.get("PYTEST_GLOBAL_TIMEOUT")
    if budget:
        # exit=True: no graceful unwind — a hung informer thread would
        # swallow anything softer. The stack dump names the deadlock.
        faulthandler.dump_traceback_later(float(budget), exit=True)


# ---------------------------------------------------------------------------
# The standard cluster: store + drivers + control plane + DeviceClasses
# ---------------------------------------------------------------------------

def make_tpu_registry(side: int = 4):
    """One-rack TPU cluster + registry with the standard device classes
    (tpu.google.com chips via TpuDriver, DCN NICs via IciDriver)."""
    cluster = build_tpu_cluster(1, TpuPodSpec(x=side, y=side))
    reg = DriverRegistry()
    reg.add(TpuDriver(cluster)).add(IciDriver(cluster))
    return cluster, reg


def make_tpu_plane(side: int = 4, **kwargs) -> ControlPlane:
    """The canonical test control plane, discovery already run."""
    cluster, reg = make_tpu_registry(side)
    plane = ControlPlane(reg, cluster, **kwargs)
    plane.run_discovery()
    return plane


def chip_claim(name: str, count: int, selectors=()) -> ResourceClaim:
    """An ExactCount claim on the standard chip class."""
    return ResourceClaim(name=name, spec=ClaimSpec(
        requests=[DeviceRequest(name="chips", device_class="tpu.google.com",
                                selectors=list(selectors), count=count)],
        topology_scope="cluster"))


def make_node_world(side: int = 4, lease_s: float = 0.5, **kwargs):
    """Deterministic node-plane world: inline plane + threadless agents
    + a fake wall clock.

    Returns ``(plane, nplane, clock)``. Heartbeats are manual
    (``agent.renew()``), expiry is ``clock[0] += dt`` — no sleeps, no
    threads, so same inputs give byte-identical placements.
    """
    from repro.node import NodePlane

    cluster, reg = make_tpu_registry(side)
    plane = ControlPlane(reg, cluster, reconcile_mode="inline", **kwargs)
    clock = [1000.0]
    plane.node_clock = lambda: clock[0]
    nplane = NodePlane(plane, lease_duration_s=lease_s).start(
        start_threads=False)
    return plane, nplane, clock


def renew_alive(nplane) -> None:
    """Heartbeat every still-alive agent (the manual-clock harness)."""
    for agent in nplane.agents.values():
        agent.renew()


# ---------------------------------------------------------------------------
# Randomized worlds (allocator equivalence + the chaos stress harness)
# ---------------------------------------------------------------------------

RACKS = ("r0", "r1", "r2")
MODELS = ("m-a", "m-b")


def random_inventory(rng):
    """A randomized but reproducible pool + classes (same seed == same
    world). Shared by the allocator-equivalence oracle tests and the
    chaos harness."""
    from repro.core.attributes import AttributeSet
    from repro.core.claims import DeviceClass
    from repro.core.resources import Device, ResourcePool, ResourceSlice

    pool = ResourcePool()
    n_nodes = rng.randint(2, 5)
    for n in range(n_nodes):
        node = f"node-{n}"
        sl = ResourceSlice(driver="drv", pool=f"p{n % 2}", node=node)
        for i in range(rng.randint(2, 7)):
            attrs = {
                "drv/rack": rng.choice(RACKS),
                "drv/model": rng.choice(MODELS),
                "drv/index": i,
            }
            if rng.random() < 0.8:      # sometimes absent -> constraint fail
                attrs["drv/pciRoot"] = f"pci{rng.randint(0, 2)}"
            sl.add(Device(name=f"d{n}-{i}",
                          attributes=AttributeSet.of(attrs)))
        pool.publish(sl)
    classes = {
        "any": DeviceClass("any", selectors=['device.driver == "drv"']),
        "model-a": DeviceClass("model-a", selectors=[
            'device.attributes["model"] == "m-a"']),
    }
    return pool, classes


def random_claims(rng, n_claims):
    """Randomized claims against a :func:`random_inventory` world."""
    from repro.core.claims import MatchAttribute

    claims = []
    for c in range(n_claims):
        n_reqs = rng.randint(1, 2)
        reqs = []
        for r in range(n_reqs):
            sel = []
            if rng.random() < 0.4:
                sel.append(
                    f'device.attributes["index"] >= {rng.randint(0, 2)}')
            reqs.append(DeviceRequest(
                name=f"req{r}", device_class=rng.choice(["any", "model-a"]),
                selectors=sel, count=rng.randint(1, 3)))
        constraints = []
        if rng.random() < 0.5:
            constraints.append(MatchAttribute(
                attribute=rng.choice(["rack", "pciRoot"]),
                requests=[r.name for r in reqs if rng.random() < 0.8]))
        claims.append(ResourceClaim(
            name=f"claim-{c}",
            spec=ClaimSpec(requests=reqs, constraints=constraints,
                           topology_scope=rng.choice(["node", "cluster"]))))
    return claims


@pytest.fixture
def plane_factory():
    """Factory fixture: ``plane_factory(side=2, admission=False)``."""
    return make_tpu_plane


@pytest.fixture
def plane() -> ControlPlane:
    """The default 4x4 (16-chip) control plane."""
    return make_tpu_plane()

"""The port's node and rollout planes and startup model against the JAX package's.

Deterministic worlds on both sides (inline plane, threadless node agents,
a fake wall clock, as ``conftest.make_node_world``), the same inputs in
the same order:

* a node turning Ready requeues the claims the scheduler found no node
  for (the port's one departure from the reference's event routing);
* node death: killing an agent lets its lease lapse, the node goes
  NotReady (``LeaseExpired``), its claims are evicted and re-placed on
  the nodes and devices JAX places them on, over seeded kill schedules;
* the scheduler: every plugin's filter and score per node,
  ``predicted_collective_seconds`` over seeded node sets, and
  ``ring_collective_time`` on generated inputs, exactly;
* the rollout plane: ``plan_rollout``, ``revision_hash`` and
  ``desired_revisions`` on generated inputs (hypothesis), the
  DisruptionBudget status and drain blocking, a rolling update, a canary
  that promotes and one that rolls back with a byte-identical spec, each
  step's condition states equal, and a ``RolloutMonitor`` that records
  no violation;
* ``core/lifecycle.py``: the same startup samples and Table I
  percentiles for the same seed.
"""

import json
import random
import re

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.core.lifecycle as jlife  # noqa: E402
import repro.node as jnode  # noqa: E402
import repro.node.scheduler as jsched  # noqa: E402
import repro.rollout as jroll  # noqa: E402
import repro.rollout.canary as jcanary  # noqa: E402
import repro.serve.slo as jslo  # noqa: E402
import repro.topology.netsim as jnetsim  # noqa: E402
import repro.topology.tpu as jtpu  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.lifecycle as tlife  # noqa: E402
import repro_torch.node as tnode  # noqa: E402
import repro_torch.node.scheduler as tsched  # noqa: E402
import repro_torch.rollout as troll  # noqa: E402
import repro_torch.rollout.canary as tcanary  # noqa: E402
import repro_torch.serve.slo as tslo  # noqa: E402
import repro_torch.topology.netsim as tnetsim  # noqa: E402
import repro_torch.topology.tpu as ttpu  # noqa: E402


class Side:
    def __init__(self, api, core, tpu, node, sched, roll, canary, slo):
        self.api, self.core, self.tpu, self.node = api, core, tpu, node
        self.sched, self.roll, self.canary, self.slo = sched, roll, canary, slo


SIDES = {"jax": Side(japi, jcore, jtpu, jnode, jsched, jroll, jcanary, jslo),
         "torch": Side(tapi, tcore, ttpu, tnode, tsched, troll, tcanary, tslo)}
_MS = re.compile(r"\d+\.\d+ms")
_UID = re.compile(r"\b[0-9a-f]{12}\b")


def node_world(s, side=4, lease_s=0.5):
    cluster = s.tpu.build_tpu_cluster(1, s.tpu.TpuPodSpec(x=side, y=side))
    reg = s.core.DriverRegistry()
    reg.add(s.core.TpuDriver(cluster)).add(s.core.IciDriver(cluster))
    plane = s.api.ControlPlane(reg, cluster, reconcile_mode="inline")
    clock = [1000.0]
    plane.node_clock = lambda: clock[0]
    nplane = s.node.NodePlane(plane, lease_duration_s=lease_s).start(
        start_threads=False)
    return plane, nplane, clock


def tpu_plane(s, side=4):
    cluster = s.tpu.build_tpu_cluster(1, s.tpu.TpuPodSpec(x=side, y=side))
    reg = s.core.DriverRegistry()
    reg.add(s.core.TpuDriver(cluster)).add(s.core.IciDriver(cluster))
    plane = s.api.ControlPlane(reg, cluster)
    plane.run_discovery()
    return plane


def chip_claim(s, name, count):
    c = s.core
    return c.ResourceClaim(name=name, spec=c.ClaimSpec(
        requests=[c.DeviceRequest(name="chips", device_class="tpu.google.com",
                                  count=count)], topology_scope="cluster"))


def renew_alive(nplane):
    for agent in nplane.agents.values():
        agent.renew()


def conditions(plane):
    """(kind, name) -> condition states, measured milliseconds and uids
    (a lease holder's agent id) blanked."""
    return {(o.meta.kind, o.meta.name): [
        (c.type, c.status, c.reason, _UID.sub("<uid>", _MS.sub("<ms>", c.message)))
        for c in o.status.conditions]
        for kind in ("Node", "ResourceClaim", "Workload", "CanaryRollout",
                     "DisruptionBudget")
        for o in plane.store.list_objects(kind)}


def placements(plane):
    out = {}
    for obj in plane.store.list_objects("ResourceClaim"):
        claim = obj.spec
        out[obj.meta.name] = (
            sorted(a.ref.id for a in claim.allocation.devices)
            if claim.allocated else None,
            obj.status.outputs.get("scheduled_nodes"))
    return out


# ---------------------------------------------------------------------------
# Node death
# ---------------------------------------------------------------------------

def test_a_node_turning_ready_requeues_the_claims_it_can_place():
    """Threaded workers reconcile each kind on its own thread, so a claim
    can meet the scheduler before the lifecycle controller has judged a
    freshly registered node Ready. The node's Ready event requeues it (a
    departure from the reference, whose routing leaves the claim blocked
    until some other event, so a waiter settles it as failed)."""
    s = SIDES["torch"]
    plane, nplane, clock = node_world(s)
    plane.submit(chip_claim(s, "c", 1))
    plane._pump_events()
    rt = s.api.ControlPlaneRuntime(plane)     # its workers' step, by hand
    while ("ResourceClaim", "c") in plane.queue.pending():
        # the claim's worker runs until its own writes stop requeueing it
        plane.queue.fast_forward()
        for key in plane.queue.pop_ready(["ResourceClaim"]):
            rt._reconcile_key(key)
        plane._pump_events()
    assert plane.store.get("ResourceClaim", "c").condition("Scheduled").reason == "NoFeasibleNode"
    for key in plane.queue.pop_ready(["Node"]):
        rt._reconcile_key(key)
    assert all(o.is_true("Ready") for o in plane.store.list_objects("Node"))
    plane._pump_events()
    assert ("ResourceClaim", "c") in plane.queue.pending()
    renew_alive(nplane)
    plane.reconcile()
    assert plane.store.get("ResourceClaim", "c").is_true("Allocated", current=True)


def test_agent_kill_evicts_and_replaces_as_jax():
    out = {}
    for name, s in SIDES.items():
        plane, nplane, clock = node_world(s)
        plane.submit(chip_claim(s, "c1", 8))
        plane.submit(s.api.Workload(claim="c1", build_mesh=False), name="w1")
        plane.reconcile()
        before = placements(plane)
        victim = sorted({a.ref.node for a in
                         plane.store.get("ResourceClaim", "c1").spec.allocation.devices})[0]
        nplane.agents[victim].kill()
        clock[0] += 10.0
        renew_alive(nplane)
        plane.reconcile()
        node = plane.store.get("Node", victim)
        ready = node.condition(s.api.CONDITION_READY)
        after = placements(plane)
        assert not ready.true and ready.reason == "LeaseExpired"
        assert victim not in {d.split("/")[0] for d in after["c1"][1]}
        assert plane.store.get("Workload", "w1").is_true(s.api.CONDITION_READY,
                                                         current=True)
        lifecycle = next(c for c in plane.controllers
                         if type(c).__name__ == "NodeLifecycleController")
        out[name] = (before, victim, after, conditions(plane))
        if name == "torch":
            assert lifecycle.evictions == 1
    assert out["torch"] == out["jax"]
    assert out["torch"][0] != out["torch"][2]


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_seeded_kill_schedules_match_jax(seed):
    out = {}
    for name, s in SIDES.items():
        rng = random.Random(seed)
        plane, nplane, clock = node_world(s, side=6)
        for i in range(10):
            plane.submit(chip_claim(s, f"c{i}", rng.choice((1, 2, 4))))
            if rng.random() < 0.3:
                alive = [n for n in sorted(nplane.agents) if nplane.agents[n].alive]
                if len(alive) > 3:
                    nplane.agents[rng.choice(alive)].kill()
                    clock[0] += 10.0
                    renew_alive(nplane)
            plane.reconcile()
        dead = sorted(n for n, a in nplane.agents.items() if not a.alive)
        out[name] = (placements(plane), dead, conditions(plane))
    assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# Scheduler and the collective model
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(collective=st.sampled_from(["all_gather", "reduce_scatter", "all_reduce",
                                   "all_to_all", "collective_permute"]),
       size=st.floats(0, 1e12), n=st.integers(0, 64),
       bw=st.floats(1.0, 500.0), dmean=st.floats(0.0, 16.0),
       dmax=st.integers(1, 16), bidir=st.booleans())
def test_ring_collective_time_matches_jax(collective, size, n, bw, dmean, dmax, bidir):
    args = (collective, size, n, bw, dmean, dmax)
    assert (tnetsim.ring_collective_time(*args, bidirectional=bidir)
            == jnetsim.ring_collective_time(*args, bidirectional=bidir))


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_scores_match_jax(seed):
    out = {}
    for name, s in SIDES.items():
        rng = random.Random(seed)
        plane, nplane, clock = node_world(s, side=8)
        for i in range(rng.randint(1, 4)):        # some capacity in use
            plane.submit(chip_claim(s, f"busy{i}", rng.choice((1, 2, 4))))
        plane.reconcile()
        sched = next(c for c in plane.controllers
                     if type(c).__name__ == "SchedulerController")
        count = rng.choice((4, 8, 16))
        claim = chip_claim(s, "probe", count)
        infos = sched._node_infos(plane, claim)
        ctx = s.sched.SchedulerContext(plane=plane, obj=None, claim=claim,
                                       needs={"chips": count})
        per_node = [(i.name, [(type(p).__name__, p.filter(ctx, i), p.score(ctx, i))
                              for p in sched.plugins]) for i in infos]
        chosen = sched._set_picker.grow(ctx, infos)
        names = sorted(i.name for i in infos)
        sets = [[i for i in infos if i.name in rng.sample(names, k)]
                for k in (1, 2, 4) for _ in range(4)]
        predicted = [s.sched.predicted_collective_seconds(plane, sub, count)
                     for sub in sets + [chosen]]
        out[name] = (per_node, [i.name for i in chosen], predicted)
    assert out["torch"] == out["jax"]
    assert any(p > 0 for p in out["torch"][2])


# ---------------------------------------------------------------------------
# Rollout strategy on generated inputs
# ---------------------------------------------------------------------------

claim_sets = st.lists(st.tuples(st.sampled_from(["a", "b", "c", "d", "e", "f", "g"]),
                                st.sampled_from(["r1", "r2", "r3"]), st.booleans()),
                      max_size=7, unique_by=lambda t: t[0])


@settings(max_examples=300, deadline=None)
@given(claims=claim_sets,
       desired=st.dictionaries(st.sampled_from(["r1", "r2", "r3"]),
                               st.integers(1, 4), min_size=1, max_size=2),
       surge=st.integers(0, 2), unavail=st.integers(0, 2))
def test_plan_rollout_matches_jax(claims, desired, surge, unavail):
    replicas = sum(desired.values())
    kw = dict(replicas=replicas, max_surge=surge, max_unavailable=unavail)
    assert (vars(troll.plan_rollout(claims, desired, **kw))
            == vars(jroll.plan_rollout(claims, desired, **kw)))


configs = st.dictionaries(st.sampled_from(["batch", "chunk", "kernel", "dtype"]),
                          st.one_of(st.integers(-8, 64), st.text(max_size=4),
                                    st.booleans()), max_size=3)


@settings(max_examples=200, deadline=None)
@given(gen=st.integers(0, 1000), config=configs, overlay=configs,
       replicas=st.integers(1, 6), canary=st.integers(0, 6))
def test_revisions_match_jax(gen, config, overlay, replicas, canary):
    assert troll.revision_hash(gen, config) == jroll.revision_hash(gen, config)
    canary = min(canary, replicas) if overlay else 0
    wls = [s.api.Workload(claim_template="rep", replicas=replicas, role="serve",
                          runtime_config=dict(config), canary_config=dict(overlay),
                          canary_replicas=canary) for s in SIDES.values()]
    assert (troll.strategy.desired_revisions(wls[1], gen)
            == jroll.strategy.desired_revisions(wls[0], gen))


# ---------------------------------------------------------------------------
# Rollout plane end to end
# ---------------------------------------------------------------------------

def submit_replicaset(s, plane, replicas=3, max_surge=1, runtime_config=None):
    c = s.core
    plane.submit(c.ResourceClaimTemplate(name="rep", spec=c.ClaimSpec(
        requests=[c.DeviceRequest(name="chips", device_class="tpu.google.com",
                                  count=1)], topology_scope="cluster")))
    plane.submit(s.api.Workload(claim_template="rep", replicas=replicas, role="serve",
                                max_surge=max_surge, max_unavailable=0,
                                runtime_config=dict(runtime_config or {})), name="srv")
    return plane.wait_for("Workload", "srv")


def replica_nodes(plane):
    return {o.meta.name: sorted({a.ref.node for a in o.spec.allocation.devices})
            for o in plane.store.list_objects("ResourceClaim", selector={"workload": "srv"})
            if o.spec.allocated}


def test_budgets_and_drain_match_jax():
    out = {}
    for name, s in SIDES.items():
        plane, nplane, clock = node_world(s)
        monitor = s.roll.RolloutMonitor().attach(plane)
        submit_replicaset(s, plane)
        plane.submit(s.api.DisruptionBudget(name="pdb", selector={"workload": "srv"},
                                            min_available=3))
        plane.reconcile()
        budget = plane.store.get("DisruptionBudget", "pdb").status.outputs["budget"]
        victim = replica_nodes(plane)[sorted(replica_nodes(plane))[0]][0]
        plane.edit("Node", victim, lambda n: setattr(n, "drain", True))
        plane.reconcile()
        blocked = conditions(plane)
        plane.edit("DisruptionBudget", "pdb", lambda b: setattr(b, "min_available", 1))
        plane.reconcile()
        plane.wait_for("Workload", "srv")
        out[name] = (budget, victim, blocked, conditions(plane), replica_nodes(plane))
        assert monitor.violations == []
    assert out["torch"] == out["jax"]
    assert out["torch"][0] == {"matched": 3, "ready": 3, "disruptions_allowed": 0}
    assert out["torch"][1] not in sum(out["torch"][4].values(), [])


def test_rolling_update_matches_jax():
    out = {}
    for name, s in SIDES.items():
        plane = tpu_plane(s)
        monitor = s.roll.RolloutMonitor().attach(plane)
        submit_replicaset(s, plane, runtime_config={"batch": 8})
        steps = []
        plane.edit("Workload", "srv", lambda w: setattr(w, "runtime_config", {"batch": 16}))
        for _ in range(12):
            try:
                plane.reconcile(max_rounds=1)       # one round at a time
            except RuntimeError:
                pass
            steps.append(plane.store.get("Workload", "srv").status.outputs.get("rollout"))
        plane.wait_for("Workload", "srv")
        out[name] = (steps, conditions(plane), placements(plane))
        assert monitor.violations == []
    assert out["torch"] == out["jax"]


def canary_run(s, p95, errors=0):
    plane = tpu_plane(s)
    monitor = s.roll.RolloutMonitor().attach(plane)
    submit_replicaset(s, plane, runtime_config={"batch": 8})
    prior = s.canary.spec_blob(plane.store.get("Workload", "srv").spec)
    plane.submit(s.api.CanaryRollout(
        name="cr", workload="srv", config={"batch": 32}, replicas=1,
        slo={"p95_latency_ms": 50.0, "error_rate": 0.02}, min_samples=4))
    plane.reconcile()
    deployed = plane.store.get("CanaryRollout", "cr").status.outputs["canary"]
    tracker = s.slo.SloTracker()
    for i in range(8):
        tracker.observe("baseline", 10.0)
        tracker.observe("canary", p95, error=i < errors)
    tracker.publish(plane, "srv")
    plane.reconcile()
    plane.wait_for("Workload", "srv")
    state = plane.store.get("CanaryRollout", "cr").status.outputs["canary"]
    after = s.canary.spec_blob(plane.store.get("Workload", "srv").spec)
    assert monitor.violations == []
    canary = next(c for c in plane.controllers
                  if type(c).__name__ == "CanaryController")
    counts = getattr(canary, "transitions", None)   # the port's plain counts
    return (prior, deployed, state, after, conditions(plane)), counts


@pytest.mark.parametrize("case", ["promote", "rollback-p95", "rollback-errors"])
def test_canary_matches_jax(case):
    p95, errors = {"promote": (10.0, 0), "rollback-p95": (500.0, 0),
                   "rollback-errors": (10.0, 4)}[case]
    out = {name: canary_run(s, p95, errors) for name, s in SIDES.items()}
    assert out["torch"][0] == out["jax"][0]
    prior, deployed, state, after, _ = out["torch"][0]
    assert deployed["phase"] == tcanary.PHASE_DEPLOYED
    if case == "promote":
        assert state["phase"] == tcanary.PHASE_PROMOTED
        assert json.loads(after)["f"]["runtime_config"] != json.loads(prior)["f"]["runtime_config"]
    else:
        assert state["phase"] == tcanary.PHASE_ROLLED_BACK
        assert after == prior                    # byte-identical restore
    assert out["torch"][1] == {tcanary.PHASE_DEPLOYED: 1, state["phase"]: 1}


# ---------------------------------------------------------------------------
# Startup pipelines (Table I)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", sorted(jlife.STARTUP_ARMS))
@pytest.mark.parametrize("seed", [0, 7, 42])
def test_lifecycle_samples_match_jax(arm, seed):
    got = tlife.simulate(tlife.STARTUP_ARMS[arm](), 200, seed=seed)
    want = jlife.simulate(jlife.STARTUP_ARMS[arm](), 200, seed=seed)
    assert got == want
    assert tlife.percentiles(got) == jlife.percentiles(want)
    t, j = tlife.STARTUP_ARMS[arm](), jlife.STARTUP_ARMS[arm]()
    assert (t.components, t.apiserver_calls_on_path, t.critical_steps) == \
        (j.components, j.apiserver_calls_on_path, j.critical_steps)


def test_table_one_percentiles():
    pct = tlife.percentiles(tlife.simulate(tlife.STARTUP_ARMS["knd"](), 100, seed=42))
    assert abs(pct[50] - 1.8) < 0.15 and abs(pct[90] - 2.1) < 0.15
    assert abs(pct[99] - 2.3) < 0.2

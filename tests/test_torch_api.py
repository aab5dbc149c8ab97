"""The port's declarative control plane against the JAX package's, on the CPU.

* The tables both packages must share: ``SYNC_POINTS`` letter for
  letter, and the persistence codec (``FORMAT_VERSION``, every tag's
  type name and persisted fields).
* Seeded random worlds (``conftest.random_inventory`` /
  ``random_claims``, carried into the port's types through the codec)
  and the standard TPU cluster with serve replica sets and planned
  workloads, submitted in the same order to both planes: the same
  allocation per claim, the same sequence of condition states (type,
  status, reason, message) per object, and the same store dump once
  uids, timestamps, measured milliseconds and write counters are
  masked.
* State directories: one written by the JAX package recovers in the
  port and one written by the port recovers in the JAX package, each
  with the same ``store_fingerprint`` and ``allocation_records`` in
  both packages; the two packages' directories for the same scenario
  differ, masked, only in the mesh output's type name (``Mesh`` against
  ``DeviceMesh``); a port plane recovered from the JAX directory adopts
  its claims with byte-identical allocations.
* Threaded reconciliation (``ControlPlaneRuntime``) converges to the
  inline plane's allocations, and so does a threaded run under a seeded
  ``FaultInjector`` with delays and a kill budget. Every runtime is
  stopped (its threads joined within a timeout) and every injector
  uninstalled.
"""

import dataclasses
import json
import random
import re

import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
import repro.api.chaos as jchaos  # noqa: E402
import repro.api.persistence as jpers  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.topology.tpu as jtpu  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
import repro_torch.api.chaos as tchaos  # noqa: E402
import repro_torch.api.persistence as tpers  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.topology.tpu as ttpu  # noqa: E402
from conftest import random_claims, random_inventory  # noqa: E402

SIDES = {"jax": (japi, jcore, jtpu, jpers), "torch": (tapi, tcore, ttpu, tpers)}
JOIN_S = 20.0


# ---------------------------------------------------------------------------
# Shared tables
# ---------------------------------------------------------------------------

def test_sync_points_equal_jax():
    assert tchaos.SYNC_POINTS == jchaos.SYNC_POINTS


def test_codec_table_equal_jax():
    assert tpers.FORMAT_VERSION == jpers.FORMAT_VERSION
    want = {tag: (cls.__name__, fields)
            for tag, (cls, fields) in jpers._DATACLASS_CODECS.items()}
    got = {tag: (cls.__name__, fields)
           for tag, (cls, fields) in tpers._DATACLASS_CODECS.items()}
    assert got == want
    for tag, (cls, fields) in tpers._DATACLASS_CODECS.items():
        assert {f.name for f in dataclasses.fields(cls)} == set(fields), tag
    assert ({c.__name__: k for c, k in tapi.KIND_OF.items()}
            == {c.__name__: k for c, k in japi.KIND_OF.items()})


# ---------------------------------------------------------------------------
# Masked comparison helpers
# ---------------------------------------------------------------------------

_UID = re.compile(r"\b[0-9a-f]{12}\b")
_MS = re.compile(r"\d+\.\d+ms")
# fields and outputs whose values are clocks or measured durations, and
# the store's write counter (a condition message that carries a measured
# duration is rewritten when it changes, in both packages)
_VOLATILE = {"created", "last_transition", "acquired", "renew_time",
             "phase_latency_s", "duration_s", "resource_version"}


def masked(value, uids=None):
    """A codec dump with uids numbered by first appearance, clock and
    duration values dropped and measured milliseconds blanked."""
    uids = {} if uids is None else uids
    if isinstance(value, str):
        value = _MS.sub("<ms>", value)
        return _UID.sub(lambda m: "uid%d" % uids.setdefault(m.group(0), len(uids)),
                        value)
    if isinstance(value, list):
        if len(value) == 2 and isinstance(value[0], str) and value[0] in _VOLATILE:
            return [value[0], "<volatile>"]
        return [masked(v, uids) for v in value]
    if isinstance(value, dict):
        return {k: ("<volatile>" if k in _VOLATILE else masked(v, uids))
                for k, v in value.items()}
    return value


def masked_dump(side, store):
    pers = SIDES[side][3]
    return masked(json.loads(pers.store_dump_json(store)))


class ConditionLog:
    """Every object's sequence of condition states, from the watch stream."""

    def __init__(self, store):
        self.seq = {}
        store.add_journal(self.on_event)

    def on_event(self, event):
        obj = event.object
        if obj is None:
            return
        state = tuple((c.type, c.status, c.reason, _MS.sub("<ms>", c.message))
                      for c in obj.status.conditions)
        seq = self.seq.setdefault((event.kind, event.name), [])
        if not seq or seq[-1] != state:
            seq.append(state)


def allocations(side, store):
    pers = SIDES[side][3]
    return {o.meta.name: json.dumps(pers.encode(o.spec.allocation), sort_keys=True)
            for o in store.list_objects("ResourceClaim")}


def delete_claim(plane, name):
    """Tear a claim down as ``ControlPlaneRuntime.delete_claim`` does."""
    with plane.mutate():
        claim = plane.store.get("ResourceClaim", name).spec
        plane.unprepare(claim)
        if claim.allocated:
            plane.allocator.deallocate(claim)
        plane.store.delete("ResourceClaim", name)


def to_torch(value):
    """A JAX-package API value as the port's, through the shared codec."""
    return tpers.decode(json.loads(json.dumps(jpers.encode(value))))


# ---------------------------------------------------------------------------
# Random worlds
# ---------------------------------------------------------------------------

def random_plane(side, seed, mode):
    api, core = SIDES[side][:2]
    rng = random.Random(seed)
    pool, classes = random_inventory(rng)
    claims = random_claims(rng, 8)
    if side == "torch":
        tpool = tcore.ResourcePool()
        for sl in pool.slices:
            tpool.publish(to_torch(sl))
        pool = tpool
        classes = {k: to_torch(c) for k, c in classes.items()}
        claims = [to_torch(c) for c in claims]
    reg = core.DriverRegistry(pool=pool)
    reg.classes.update(classes)
    plane = api.ControlPlane(reg, reconcile_mode=mode)
    log = ConditionLog(plane.store)
    plane.run_discovery()
    return plane, log, claims, rng


@pytest.mark.parametrize("mode", ["event", "inline"])
@pytest.mark.parametrize("seed", range(6))
def test_random_worlds_match_jax(seed, mode):
    out = {}
    for side in SIDES:
        plane, log, claims, rng = random_plane(side, seed, mode)
        rejected = []
        for i, claim in enumerate(claims):
            try:
                plane.submit(claim)
            except SIDES[side][0].AdmissionError as e:
                rejected.append(str(e))
            if i % 3 == 2:
                plane.reconcile()
        plane.reconcile()
        # churn: delete a seeded subset, then reconcile what it freed
        for claim in claims:
            if (rng.random() < 0.3
                    and plane.store.try_get("ResourceClaim", claim.name)):
                delete_claim(plane, claim.name)
        plane.reconcile()
        out[side] = (allocations(side, plane.store), log.seq,
                     masked_dump(side, plane.store), rejected)
    for got, want in zip(out["torch"], out["jax"]):
        assert got == want
    assert any(a != "null" for a in out["torch"][0].values())


def tpu_plane(side, state_dir=None, side_len=4, runtime=None, **kw):
    api, core, tpu = SIDES[side][:3]
    cluster = tpu.build_tpu_cluster(1, tpu.TpuPodSpec(x=side_len, y=side_len))
    reg = core.DriverRegistry()
    reg.add(core.TpuDriver(cluster)).add(core.IciDriver(cluster))
    if runtime is not None:
        kw["runtime"] = runtime
    return api.ControlPlane.open(state_dir, reg, cluster, announce=None, **kw)


def submit_scenario(side, plane, build_mesh=False):
    """A training claim + planned workload and a serve replica set."""
    api, core = SIDES[side][:2]
    plane.submit(plane.planner.make_claim("train", 1))
    plane.submit(api.Workload(claim="train", axes=[core.AxisSpec("data", 1, "y"),
                                                   core.AxisSpec("model", 1, "x")],
                              build_mesh=build_mesh), name="train-job")
    plane.submit(core.ResourceClaimTemplate(name="serve-replica", spec=core.ClaimSpec(
        requests=[core.DeviceRequest(name="chips", device_class="tpu.google.com",
                                     count=2)], topology_scope="cluster")))
    plane.submit(api.Workload(claim_template="serve-replica", role="serve", replicas=3),
                 name="serve")
    return [plane.wait_for("Workload", n) for n in ("train-job", "serve")]


def test_tpu_scenario_matches_jax():
    """Planned workload, replica set, scale down and a template edit
    (a rolling update), condition by condition."""
    out = {}
    for side in SIDES:
        plane = tpu_plane(side, reconcile_mode="inline")
        log = ConditionLog(plane.store)
        submit_scenario(side, plane)
        plane.edit("Workload", "serve", lambda w: setattr(w, "replicas", 2))
        plane.wait_for("Workload", "serve")
        plane.edit("ResourceClaimTemplate", "serve-replica",
                   lambda t: setattr(t.spec.requests[0], "count", 1))
        wl = plane.wait_for("Workload", "serve")
        plan = plane.store.get("Workload", "train-job").status.outputs["plan"]
        out[side] = (allocations(side, plane.store), log.seq,
                     masked_dump(side, plane.store), plan.summary(),
                     wl.status.outputs["rollout"])
    for got, want in zip(out["torch"], out["jax"]):
        assert got == want


# ---------------------------------------------------------------------------
# State directories across the packages
# ---------------------------------------------------------------------------

@pytest.fixture
def gloo_world1(tmp_path):
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rdzv'}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def write_state(side, state_dir):
    runtime = tcore.MeshRuntime("cpu") if side == "torch" else None
    plane = tpu_plane(side, str(state_dir), runtime=runtime)
    train, serve = submit_scenario(side, plane, build_mesh=True)
    mesh = train.status.outputs["mesh"]
    plane.journal.close()
    return type(mesh).__name__


def test_state_dirs_recover_across_packages(tmp_path, gloo_world1):
    dirs = {side: tmp_path / side for side in SIDES}
    meshes = {side: write_state(side, d) for side, d in dirs.items()}
    assert meshes == {"jax": "Mesh", "torch": "DeviceMesh"}
    recovered = {}
    for writer, d in dirs.items():
        fps = {}
        for reader in SIDES:
            pers = SIDES[reader][3]
            store, info = pers.recover_store(str(d))
            fps[reader] = (pers.store_fingerprint(store), pers.allocation_records(store),
                           info.objects, info.resource_version)
            if reader == writer:
                recovered[writer] = masked(json.loads(pers.store_dump_json(store)))
        assert fps["torch"] == fps["jax"], writer
        assert len(fps["jax"][1]) == 4          # train + three serve replicas
    text = {side: json.dumps(recovered[side], sort_keys=True) for side in SIDES}
    assert text["torch"] != text["jax"]
    assert text["torch"].replace('"DeviceMesh"', '"Mesh"') == text["jax"]


def test_port_adopts_a_jax_state_dir(tmp_path, gloo_world1):
    write_state("jax", tmp_path)
    store, _ = jpers.recover_store(str(tmp_path))
    before = jpers.allocation_records(store)
    plane = tpu_plane("torch", str(tmp_path), runtime=tcore.MeshRuntime("cpu"))
    assert plane.adoption_stats["adopted"] == 4 and plane.adoption_stats["lost"] == 0
    train = plane.wait_for("Workload", "train-job")
    plane.wait_for("Workload", "serve")
    assert type(train.status.outputs["mesh"]).__name__ == "DeviceMesh"
    assert tpers.allocation_records(plane.store) == before
    plane.journal.close()


# ---------------------------------------------------------------------------
# Threaded reconciliation and faults
# ---------------------------------------------------------------------------

def claims_for(side, n):
    core = SIDES[side][1]
    return [core.ResourceClaim(name=f"c{i}", spec=core.ClaimSpec(
        requests=[core.DeviceRequest(name="chips", device_class="tpu.google.com",
                                     count=1 + i % 3)], topology_scope="cluster"))
            for i in range(n)]


def threaded_allocations(injector=None):
    plane = tpu_plane("torch")
    prev = tchaos.install(injector)
    rt = tapi.ControlPlaneRuntime(plane).start()
    try:
        for c in claims_for("torch", 6):
            plane.submit(c)
            plane.wait_for("ResourceClaim", c.name, condition=tapi.CONDITION_ALLOCATED)
        plane.submit(tapi.Workload(claim_template="", claim="c0", role="serve"),
                     name="wl")
        plane.wait_for("Workload", "wl")
        rt.delete_claim("c1")
        plane.submit(claims_for("torch", 7)[-1])
        plane.wait_for("ResourceClaim", "c6", condition=tapi.CONDITION_ALLOCATED)
        rt.wait_quiesce(JOIN_S)
    finally:
        stats = rt.stop(timeout=JOIN_S)
        tchaos.install(prev)
    assert not [t for t in [rt._informer, *rt._workers.values()] if t and t.is_alive()]
    return allocations("torch", plane.store), stats


def inline_allocations(side):
    plane = tpu_plane(side, reconcile_mode="inline")
    for c in claims_for(side, 6):
        plane.submit(c)
        plane.wait_for("ResourceClaim", c.name, condition=SIDES[side][0].CONDITION_ALLOCATED)
    plane.submit(SIDES[side][0].Workload(claim="c0", role="serve"), name="wl")
    plane.wait_for("Workload", "wl")
    delete_claim(plane, "c1")
    plane.submit(claims_for(side, 7)[-1])
    plane.wait_for("ResourceClaim", "c6", condition=SIDES[side][0].CONDITION_ALLOCATED)
    return allocations(side, plane.store)


def test_threaded_converges_to_inline():
    want = inline_allocations("jax")
    assert inline_allocations("torch") == want
    got, stats = threaded_allocations()
    assert got == want
    assert stats.panics == 0 and stats.reconciled > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_fault_injector_run_converges(seed):
    inj = tchaos.FaultInjector(seed, delay_points=("store.", "workqueue.", "runtime."),
                               delay_prob=0.2, max_delay_s=0.001,
                               kill_points=("runtime.worker.",), kill_prob=0.3,
                               max_kills=2)
    got, stats = threaded_allocations(inj)
    assert got == inline_allocations("jax")
    assert inj.kills <= 2 and stats.panics == inj.kills
    assert inj.delays > 0 and sum(inj.hits.values()) > 0
    assert inj.summary()["delay_hist"]

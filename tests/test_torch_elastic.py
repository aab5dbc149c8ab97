"""The port's elastic re-planning against the JAX package's, on the CPU.

Every case of ``tests/test_elastic.py`` runs on the port and on JAX on
the same cluster, and the port's plan shapes, dilations, claims and
``events`` are JAX's: ``largest_mesh_shape``; the initial plan; a node
failure re-planning a smaller mesh (its chips and DCN NIC withdrawn);
``JOB_RESUMED`` carrying the plan; NICs not inflating the mesh;
sequential failures; host-attributed straggler strikes escalating and
unattributed ones not; ``TelemetryDriver`` stamping its host. Beside
them: a restarted controller on the same ``state_dir`` restores its
strikes from the WAL, and the threaded controller with the node plane
re-plans through the lease-expiry eviction.

Then the end-to-end run: smoke h2o-danube-1.8b in f32 (JAX's weights
through ``repro_torch.convert``, handed to the ranks as the port's step-0
checkpoint; data 8 x 32, AdamW at 1e-3, remat dots)
on ``TpuPodSpec(x=1, y=4)`` with ``model_axis=1``. Four gloo ranks (a
(4, 1) mesh) train until ``FaultInjector(fail_at=5)`` stops every rank,
with a checkpoint at step 3; the controller re-plans (2, 1) on the
surviving host, and two new gloo ranks restore step 3 onto the new mesh
and train 3 more steps. Every step's loss is within 1e-4 relative of
JAX's run of the same plan, which trains in a subprocess on 4 fake host
devices, on the same weights and data. Every subprocess has a timeout.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.core import DriverRegistry as JaxDriverRegistry  # noqa: E402
from repro.core import IciDriver as JaxIciDriver  # noqa: E402
from repro.core import TpuDriver as JaxTpuDriver  # noqa: E402
from repro.core.nri import Events as JaxEvents  # noqa: E402
from repro.launch import elastic as jelastic  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.topology import tpu as jtpu  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import DriverRegistry, IciDriver, TpuDriver  # noqa: E402
from repro_torch.core.nri import EventBus, Events  # noqa: E402
from repro_torch.launch import elastic  # noqa: E402
from repro_torch.launch.elastic import ElasticController, largest_mesh_shape  # noqa: E402
from repro_torch.topology.tpu import TpuPodSpec, build_tpu_cluster  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.schedule import constant_schedule  # noqa: E402
from repro_torch.train.trainer import TelemetryDriver  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "h2o-danube-1.8b"
F32 = {"param_dtype": "float32", "compute_dtype": "float32"}
BATCH, SEQ, FIT, FAIL_AT, CKPT_EVERY, RESUME_STEPS = 8, 32, 10, 5, 3, 3
LOSS_REL = 1e-4
JAX_TIMEOUT_S = 600


def registries(x, y):
    """(JAX registry, port registry), each discovered on its own copy of
    one pod."""
    jcluster = jtpu.build_tpu_cluster(1, jtpu.TpuPodSpec(x=x, y=y))
    jreg = JaxDriverRegistry()
    jreg.add(JaxTpuDriver(jcluster)).add(JaxIciDriver(jcluster))
    jreg.run_discovery()
    cluster = build_tpu_cluster(1, TpuPodSpec(x=x, y=y))
    reg = DriverRegistry()
    reg.add(TpuDriver(cluster)).add(IciDriver(cluster))
    reg.run_discovery()
    return (jcluster, jreg), (cluster, reg)


def controllers(x=4, y=4, **kw):
    """(JAX controller, port controller) on one pod; inline unless asked:
    unit tests should not each leak an informer thread pool."""
    kw.setdefault("model_axis", 4)
    kw.setdefault("reconcile_mode", "inline")
    (jcluster, jreg), (cluster, reg) = registries(x, y)
    return (jelastic.ElasticController(jcluster, jreg, **kw),
            ElasticController(cluster, reg, **kw))


def close(*ctls):
    for ctl in ctls:
        ctl.close()


def same_plans(jctl, ctl):
    """The two controllers hold the same plan, claim state and events."""
    jp, p = jctl.plan, ctl.plan
    assert p.axis_shape == jp.axis_shape
    assert p.summary() == jp.summary()
    assert p.dilation == jp.dilation
    assert p.link_class == jp.link_class
    assert p.chip_grid.tolist() == jp.chip_grid.tolist()
    assert (ctl.claim.allocated, ctl.claim.prepared) == (jctl.claim.allocated,
                                                         jctl.claim.prepared)
    assert ctl.events == jctl.events


class TestLargestMeshShape:
    def test_exact(self):
        assert largest_mesh_shape(16, 4) == (4, 4) == jelastic.largest_mesh_shape(16, 4)

    def test_rounds_down_to_pow2(self):
        assert largest_mesh_shape(12, 4) == (2, 4) == jelastic.largest_mesh_shape(12, 4)

    def test_too_small_raises(self):
        with pytest.raises(ValueError):
            largest_mesh_shape(2, 4)


class TestElasticReplan:
    def test_initial_plan(self):
        jctl, ctl = controllers()
        plan = ctl.plan_mesh()
        jctl.plan_mesh()
        assert ctl.mesh_shape == (4, 4)
        assert plan.dilation["model"][0] == 1.0
        same_plans(jctl, ctl)

    def test_node_failure_replans_smaller(self):
        jctl, ctl = controllers()
        for c in (jctl, ctl):
            c.plan_mesh()
        pool = ctl.registry.pool
        node = pool.nodes()[0]
        n_before = len(pool.devices(include_allocated=True))
        for c, events in ((jctl, JaxEvents), (ctl, Events)):
            c.registry.bus.publish(events.NODE_FAILED, node=node)
        # 16 chips - 4 (one host) = 12 -> (2, 4) mesh
        assert ctl.mesh_shape == (2, 4)
        n_after = len(ctl.registry.pool.devices(include_allocated=True))
        assert n_after == n_before - 4 - 1  # 4 chips + host dcn nic
        assert node not in ctl.registry.pool.nodes()
        same_plans(jctl, ctl)

    def test_replan_emits_job_resumed(self):
        jctl, ctl = controllers()
        seen = []
        for c, events in ((jctl, JaxEvents), (ctl, Events)):
            c.plan_mesh()
            resumed = []
            c.registry.bus.subscribe(events.JOB_RESUMED,
                                     lambda e, r=resumed: r.append(e.context), "watch")
            c.registry.bus.publish(events.NODE_FAILED, node=c.registry.pool.nodes()[0])
            seen.append(resumed)
        jres, res = seen
        assert len(res) == 1 == len(jres)
        assert res[0]["plan"].axis_shape == (2, 4)
        assert res[0]["plan"].summary() == jres[0]["plan"].summary()
        assert res[0]["reason"] == jres[0]["reason"] == "lost pod0/host0_0"
        same_plans(jctl, ctl)

    def test_nic_devices_do_not_inflate_mesh(self):
        """Pool NICs must not count as chips when sizing the mesh: the
        4 x 14 pod's 56 chips and 14 host NICs give (8, 4), threaded."""
        jctl, ctl = controllers(x=4, y=14, reconcile_mode="threaded")
        try:
            for c in (jctl, ctl):
                c.plan_mesh()
            assert ctl.mesh_shape == (8, 4)
            same_plans(jctl, ctl)
        finally:
            close(jctl, ctl)

    def test_sequential_failures(self):
        jctl, ctl = controllers()
        for c, events in ((jctl, JaxEvents), (ctl, Events)):
            c.plan_mesh()
            for _ in range(2):
                c.registry.bus.publish(events.NODE_FAILED, node=c.registry.pool.nodes()[0])
        assert ctl.mesh_shape in ((2, 4), (1, 4))
        # claim is re-allocated and prepared each time
        assert ctl.claim.allocated and ctl.claim.prepared
        same_plans(jctl, ctl)


class TestStragglerStrikes:
    def test_host_attributed_strikes_escalate_to_failure(self):
        jctl, ctl = controllers()
        node = ctl.registry.pool.nodes()[0]
        for c, events in ((jctl, JaxEvents), (ctl, Events)):
            c.plan_mesh()
            for step in range(c.straggler_strike_limit):
                c.registry.bus.publish(events.STRAGGLER_DETECTED, step=step, host=node)
        # escalated: the host was withdrawn and the mesh replanned
        assert node not in ctl.registry.pool.nodes()
        assert ctl.mesh_shape == (2, 4)
        assert node not in ctl.strikes          # reset after escalation
        assert ctl.strikes == jctl.strikes
        same_plans(jctl, ctl)

    def test_unattributed_strikes_accumulate_without_escalation(self):
        jctl, ctl = controllers()
        for c, events in ((jctl, JaxEvents), (ctl, Events)):
            c.plan_mesh()
            for step in range(c.straggler_strike_limit + 2):
                c.registry.bus.publish(events.STRAGGLER_DETECTED, step=step)
        assert ctl.strikes["unknown"] == ctl.straggler_strike_limit + 2
        assert ctl.strikes == jctl.strikes
        assert ctl.mesh_shape == (4, 4)         # nothing failed
        same_plans(jctl, ctl)

    def test_telemetry_driver_stamps_host(self):
        bus = EventBus()
        drv = TelemetryDriver(straggler_factor=2.0, host="pod0/host0_0")
        drv.register(bus)
        seen = []
        bus.subscribe(Events.STRAGGLER_DETECTED, lambda e: seen.append(e.context), "watch")
        for step in range(9):
            bus.publish(Events.STEP_BEGIN, step=step, bus=bus)
            drv._t0 -= 10.0 if step == 8 else 0.01   # step 8 stalls
            bus.publish(Events.STEP_END, step=step, bus=bus)
        assert seen and seen[-1]["host"] == "pod0/host0_0"
        assert [s["step"] for s in seen] == [8]

    def test_restarted_controller_restores_strikes(self, tmp_path):
        """Strikes persist in the workload's status outputs through the
        WAL: a controller restarted on the same state_dir keeps counting
        where the dead one stopped, and escalates on the next strike."""
        node = "pod0/host0_1"
        runs = []
        for side, events, make in (("jax", JaxEvents, jelastic.ElasticController),
                                   ("port", Events, ElasticController)):
            state = str(tmp_path / side)
            regs = registries(4, 4)
            (cluster, reg) = regs[0] if side == "jax" else regs[1]
            first = make(cluster, reg, model_axis=4, state_dir=state)
            first.plan_mesh()
            for step in range(first.straggler_strike_limit - 1):
                reg.bus.publish(events.STRAGGLER_DETECTED, step=step, host=node)
            first.close()
            (cluster, reg) = registries(4, 4)[0 if side == "jax" else 1]
            second = make(cluster, reg, model_axis=4, state_dir=state)
            try:
                restored = dict(second.strikes)
                reg.bus.publish(events.STRAGGLER_DETECTED, step=9, host=node)
                runs.append((restored, dict(second.strikes), second.mesh_shape,
                             [e for e in second.events if not e.startswith("[knd]")]))
            finally:
                second.close()
        (jrestored, jafter, jshape, jevents), (restored, after, shape, events_) = runs
        assert restored == {node: 2} == jrestored
        assert after == {} == jafter
        assert shape == (2, 4) == jshape
        assert "restored straggler strikes: {'pod0/host0_1': 2}" in events_
        assert events_ == jevents


def test_threaded_node_plane_replans_through_lease_expiry():
    """With per-node agents and the threaded informer, a failure is the
    lifecycle path: the agent is killed, its lease force-expired, and the
    NodeLifecycleController withdraws the host before the re-plan."""
    jctl, ctl = controllers(reconcile_mode="threaded", use_node_plane=True)
    try:
        for c, events in ((jctl, JaxEvents), (ctl, Events)):
            c.plan_mesh()
            node = c.registry.pool.nodes()[0]
            c.registry.bus.publish(events.NODE_FAILED, node=node)
            assert node not in c.registry.pool.nodes()
            lease_node = c.plane.store.try_get("Node", node)
            assert lease_node is None or not lease_node.is_true("Ready", current=True)
        assert ctl.mesh_shape == (2, 4)
        assert ctl.node_plane is not None and len(ctl.node_plane.agents) == 4
        assert ctl.events[:3] == ["node plane started: 4 agent(s)",
                                  "informer runtime started", "planned 4x4"]
        same_plans(jctl, ctl)
    finally:
        close(jctl, ctl)


# ---------------------------------------------------------------------------
# End to end: four gloo ranks shrink to two after a node failure
# ---------------------------------------------------------------------------

JAX_ELASTIC_SCRIPT = r"""
import os, sys, json, tempfile
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import numpy as np
import jax
from repro.core import DriverRegistry, IciDriver, TpuDriver, MeshRuntime
from repro.core.nri import Events
from repro.launch.elastic import ElasticController
from repro.topology.tpu import TpuPodSpec, build_tpu_cluster
from repro.configs.registry import smoke_config
from repro.data.pipeline import SyntheticLMData
from repro.train.optimizer import AdamW
from repro.train.schedule import constant_schedule
from repro.train.train_step import StepConfig
from repro.train.trainer import Trainer, FaultInjector
from repro.ckpt.checkpoint import CheckpointManager
from repro.parallel.sharding import ShardingRules, use_rules

weights_path, out_path = sys.argv[1], sys.argv[2]
B, S, FIT, FAIL_AT, EVERY, RESUME = (int(a) for a in sys.argv[3:9])
cluster = build_tpu_cluster(1, TpuPodSpec(x=1, y=4))
reg = DriverRegistry()
reg.add(TpuDriver(cluster)).add(IciDriver(cluster))
reg.run_discovery()
ctl = ElasticController(cluster, reg, model_axis=1)
plan = ctl.plan_mesh()
mesh = MeshRuntime().execute(plan.attachment())
cfg = smoke_config("h2o-danube-1.8b").replace(param_dtype="float32", compute_dtype="float32")
data = SyntheticLMData(cfg, B, S)
w = np.load(weights_path)
with tempfile.TemporaryDirectory() as d:
    ck = CheckpointManager(d, async_save=False)
    t = Trainer(cfg, AdamW(constant_schedule(1e-3)), data, ckpt=ck, ckpt_every=EVERY,
                drivers=[FaultInjector(fail_at=FAIL_AT, node=reg.pool.nodes()[0])],
                step_cfg=StepConfig(remat="dots"))
    ctl.registry.bus = t.bus
    ctl.registry.bus.subscribe(Events.NODE_FAILED, ctl.on_node_failed, "elastic")
    with use_rules(ShardingRules(mesh=mesh)):
        t.init()
        flat, treedef = jax.tree_util.tree_flatten_with_path(t.state["params"])
        leaves = [jax.numpy.asarray(w["/".join(str(k.key) for k in path)], leaf.dtype)
                  for path, leaf in flat]
        t.state = {**t.state, "params": jax.tree_util.tree_unflatten(treedef, leaves)}
        out = t.fit(FIT)
    shapes = [list(plan.axis_shape), list(ctl.mesh_shape)]
    mesh2 = MeshRuntime().execute(ctl.plan.attachment())
    t2 = Trainer(cfg, AdamW(constant_schedule(1e-3)), data, ckpt=ck,
                 step_cfg=StepConfig(remat="dots"))
    with use_rules(ShardingRules(mesh=mesh2)):
        t2.init()
        step = t2.resume()
        out2 = t2.fit(RESUME)
ctl.close()
with open(out_path, "w") as f:
    json.dump({"result": out, "shapes": shapes, "resumed_from": step, "result2": out2,
               "first": [[h["step"], h["loss"]] for h in t.history],
               "survivors": [[h["step"], h["loss"]] for h in t2.history],
               "events": ctl.events}, f)
print("JAX_ELASTIC_OK")
"""


def jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k.key) for k in path), np.asarray(leaf)) for path, leaf in flat]


def assert_losses_close(got, want):
    assert [s for s, _ in got] == [s for s, _ in want]
    for (step, a), (_, b) in zip(got, want):
        assert math.isfinite(a) and abs(a - b) <= LOSS_REL * abs(b), (step, a, b)


@pytest.fixture(scope="module")
def elastic_runs(tmp_path_factory):
    """The port's elastic run on gloo ranks and JAX's on fake devices,
    from the same weights (the ranks': a step-0 checkpoint); JAX's runs
    in a subprocess, on one thread, while the ranks do."""
    out = tmp_path_factory.mktemp("elastic")
    jcfg = jax_smoke_config(ARCH).replace(**F32)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    np.savez(out / "weights.npz", **dict(jax_paths(jparams)))
    params = convert.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    CheckpointManager(str(out / "ckpt"), async_save=False).save(0, {
        "params": params, "opt_state": AdamW(constant_schedule(1e-3)).init(params),
        "step": torch.zeros((), dtype=torch.int32)})
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    jproc = subprocess.Popen(
        [sys.executable, "-c", JAX_ELASTIC_SCRIPT, str(out / "weights.npz"),
         str(out / "jax.json"), *(str(v) for v in (BATCH, SEQ, FIT, FAIL_AT, CKPT_EVERY,
                                                   RESUME_STEPS))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
    try:
        cluster = build_tpu_cluster(1, TpuPodSpec(x=1, y=4))
        reg = DriverRegistry()
        reg.add(TpuDriver(cluster)).add(IciDriver(cluster))
        reg.run_discovery()
        ctl = ElasticController(cluster, reg, model_axis=1)
        try:
            job = {"arch": ARCH, "overrides": F32, "batch": BATCH, "seq": SEQ,
                   "steps": FIT, "ckpt_dir": str(out / "ckpt"), "ckpt_every": CKPT_EVERY}
            port = elastic._train_elastic(ctl, job, str(out / "port"), fail_at=FAIL_AT,
                                          resume_steps=RESUME_STEPS)
            port["events"] = list(ctl.events)
            port["claim"] = (ctl.claim.allocated, ctl.claim.prepared)
        finally:
            ctl.close()
        log = jproc.communicate(timeout=JAX_TIMEOUT_S)[0].decode(errors="replace")
    finally:
        if jproc.poll() is None:
            jproc.kill()
            jproc.wait()
    assert jproc.returncode == 0 and "JAX_ELASTIC_OK" in log, log[-4000:]
    return port, json.loads((out / "jax.json").read_text())


def test_elastic_run_stops_every_rank_at_the_failure(elastic_runs):
    port, jx = elastic_runs
    assert jx["result"] == {"stopped_at": FAIL_AT, "reason": "node_failure"}
    assert len(port["first"]) == 4
    for res in port["first"]:
        assert res["result"] == jx["result"]
        assert res["world"] == 4 and res["all_dtensor"]
        assert res["resumed_from"] == 0        # JAX's weights, as a step-0 checkpoint
        assert res["mesh"] == [["data", "model"], [[0], [1], [2], [3]]]
        assert res["steps"] == list(range(FAIL_AT))


def test_elastic_run_replans_the_survivors(elastic_runs):
    port, jx = elastic_runs
    assert port["shapes"] == [[4, 1], [2, 1]] == jx["shapes"]
    assert port["node"] == "pod0/host0_0"
    assert port["claim"] == (True, True)
    assert port["events"] == jx["events"]
    assert port["events"][-2:] == ["node_failed pod0/host0_0", "planned 2x1"]


def test_survivors_resume_from_step_3_on_two_gloo_ranks(elastic_runs):
    port, jx = elastic_runs
    assert jx["resumed_from"] == 3
    assert len(port["survivors"]) == 2
    for res in port["survivors"]:
        assert res["world"] == 2 and res["all_dtensor"]
        assert res["mesh"] == [["data", "model"], [[0], [1]]]
        assert res["resumed_from"] == 3
        assert res["result"]["completed"] >= 6
        assert res["result"]["completed"] == jx["result2"]["completed"]
        assert res["steps"] == [4, 5, 6]


def test_every_step_loss_equals_jax(elastic_runs):
    port, jx = elastic_runs
    for key in ("first", "survivors"):
        runs = [list(zip(r["steps"], r["losses"])) for r in port[key]]
        assert all(r == runs[0] for r in runs)          # every rank agrees
        assert_losses_close(runs[0], [tuple(x) for x in jx[key]])
    # the resumed step 4 is the failed run's step 4
    assert port["survivors"][0]["losses"][0] == port["first"][0]["losses"][4]

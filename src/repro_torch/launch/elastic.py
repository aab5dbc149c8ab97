"""Elastic re-planning: node failure -> spec edit -> reconcile -> resume.

The port of the JAX package's ``launch/elastic.py``. The KND payoff for
fault tolerance, now fully declarative: the elastic controller owns ONE
ResourceClaim and ONE Workload object in the API store. Scale-down after
a node failure is a *spec edit* (shrink the claim's chip count, shrink
the workload's axes); the control plane's reconcilers notice the lost
devices and the bumped generation, tear the stale allocation down,
re-allocate against the survivors, re-plan and re-attach — no
imperative per-node reconfiguration anywhere (the exact contrast to the
CNI-daemon lifecycle fragility of §II).

Straggler mitigation rides the same path: a STRAGGLER_DETECTED event on
the bus can be escalated by policy to treat the slow host as failed.

In torch one mesh rank is one process, and a process group cannot
shrink in place. So the controller lives in the launching process (the
control plane, not a training rank), and :func:`_train_elastic` runs a
planned mesh as gloo ranks (one process each, file rendezvous), each
building its ``DeviceMesh`` with ``MeshRuntime.execute`` of the plan's
attachment and training under the sharding rules with a ``Trainer``
until a ``FaultInjector`` stops every rank at the same step. The
launcher then publishes NODE_FAILED on the controller's bus, the
controller re-plans on the survivors, and the survivors start again as
a new process group of the smaller world, with a fresh rendezvous and
the new plan's rank grid: they restore the newest checkpoint onto the
new mesh's placements and train on. The global batch of a step does not
depend on the shard count (``data/pipeline.py``), so the resumed run
sees the batches the failed one would have.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .. import core
from ..api import (ControlPlane, ControlPlaneRuntime, Workload,
                   CONDITION_READY)
from ..core.nri import Event, Events
from ..node import NodePlane
from ..topology.tpu import TpuCluster
from . import _ranks

__all__ = ["ElasticController", "largest_mesh_shape"]

RANK_TIMEOUT_S = 300       # how long _run_ranks waits for one process group


def largest_mesh_shape(n_chips: int, model_axis: int) -> Tuple[int, int]:
    """Biggest (data, model) grid with the model axis preserved.

    Keeping the model axis intact means parameter shardings stay valid
    (only the data/batch axis shrinks), so a restore-and-resume needs no
    resharding logic beyond placing the restored leaves on the new mesh.
    """
    data = n_chips // model_axis
    if data < 1:
        raise ValueError(f"{n_chips} chips cannot host model axis {model_axis}")
    # round data down to a power of two for torus folding friendliness
    data = 2 ** int(math.floor(math.log2(data)))
    return data, model_axis


@dataclass
class ElasticController:
    """Owns the claim + workload objects across failures.

    The imperative lifecycle of the old controller (re-claim, re-solve,
    re-prepare, re-plan) now lives in the API reconcilers; this class
    only edits specs and waits for the Workload's ``Ready`` condition.
    """

    cluster: TpuCluster
    registry: core.DriverRegistry
    model_axis: int = 4
    placement: str = "aligned"
    # WAL-backed persistence: an existing state dir is recovered (the
    # claim + workload are adopted, not re-allocated); a fresh one is
    # journaled so the *next* controller restart can adopt in turn.
    state_dir: Optional[str] = None
    # "threaded" (default): a ControlPlaneRuntime's informer threads
    # converge resizes *while training steps execute* — a node failure
    # handled on the trainer's bus thread races live reconciliation and
    # still lands on the edited spec (level-triggered). "inline" keeps
    # the blocking reference arm.
    reconcile_mode: str = "threaded"
    # run per-node agents (repro_torch.node): failures are detected
    # through lease expiry + the NodeLifecycleController instead of an
    # explicit withdraw — the node-plane failure domain end to end
    use_node_plane: bool = False
    node_heartbeat_s: float = 0.1
    node_lease_s: float = 0.5
    # stragglers on the same host escalate to a node failure after this
    # many strikes; counts survive WAL recovery (workload status output)
    straggler_strike_limit: int = 3
    events: List[str] = field(default_factory=list)

    CLAIM = "elastic-train"
    WORKLOAD = "elastic-train-job"

    def __post_init__(self) -> None:
        if self.reconcile_mode not in ("threaded", "inline"):
            raise ValueError(
                f"unknown reconcile_mode {self.reconcile_mode!r} "
                f"(expected 'threaded' or 'inline')")
        self.plane = ControlPlane.open(self.state_dir, self.registry,
                                       self.cluster,
                                       announce=self.events.append)
        self.node_plane: Optional[NodePlane] = None
        if self.use_node_plane:
            # start agents BEFORE the informer: recovered Nodes carry
            # stale leases, and reconciling them agent-less would evict
            # perfectly healthy adopted claims
            # heartbeat threads run in BOTH modes: an inline reconcile
            # minutes later must still see live leases
            self.node_plane = NodePlane(
                self.plane, heartbeat_s=self.node_heartbeat_s,
                lease_duration_s=self.node_lease_s).start()
            self.events.append(
                f"node plane started: {len(self.node_plane.agents)} agent(s)")
        # recovery-aware resume: strike counts ride the workload's
        # status outputs through the WAL, so a restarted controller
        # keeps escalating where the dead one left off
        self.strikes: Dict[str, int] = {}
        wl = self.plane.store.try_get("Workload", self.WORKLOAD)
        if wl is not None:
            restored = wl.status.outputs.get("straggler_strikes", {})
            self.strikes = {str(k): int(v) for k, v in restored.items()}
            if self.strikes:
                self.events.append(f"restored straggler strikes: "
                                   f"{dict(sorted(self.strikes.items()))}")
        if self.reconcile_mode == "threaded":
            ControlPlaneRuntime(self.plane, name="elastic-informer").start()
            self.events.append("informer runtime started")
        self.registry.bus.subscribe(Events.NODE_FAILED, self.on_node_failed,
                                    "elastic-controller")
        self.registry.bus.subscribe(Events.STRAGGLER_DETECTED,
                                    self.on_straggler, "elastic-controller")

    def close(self) -> None:
        """Stop the informer runtime (joins its threads, syncs the WAL)."""
        if self.node_plane is not None:
            self.node_plane.stop()
        if self.plane.informer is not None:
            self.plane.informer.stop()

    # -- declarative state ---------------------------------------------------
    @property
    def claim(self) -> Optional[core.ResourceClaim]:
        obj = self.plane.store.try_get("ResourceClaim", self.CLAIM)
        return obj.spec if obj is not None else None

    @property
    def plan(self) -> Optional[core.MeshPlan]:
        if self.plane.store.try_get("Workload", self.WORKLOAD) is None:
            return None
        return self.plane.plan(self.WORKLOAD)

    # -- initial plan / re-plan ----------------------------------------------
    def _available_chips(self) -> int:
        """Free TPU chips plus whatever the existing claim still holds.

        Filtered to the TPU driver: the pool also carries DCN NIC
        devices, which must not inflate the mesh size.
        """
        pool = self.registry.pool
        claim = self.claim
        mine = claim.uid if claim is not None else None
        return sum(1 for d in pool.devices(include_allocated=True)
                   if d.driver == core.TpuDriver.name
                   and pool.owner(d.id) in (None, mine))

    def plan_mesh(self, n_chips: Optional[int] = None) -> core.MeshPlan:
        # size + spec edits under the reconcile lock so a concurrently
        # healing informer worker never interleaves between our read of
        # the surviving pool and the resize edit that depends on it
        with self.plane.mutate():
            n = n_chips or self._available_chips()
            data, model = largest_mesh_shape(n, self.model_axis)
            n = data * model
            axes = [core.AxisSpec("data", data, "y"),
                    core.AxisSpec("model", model, "x")]
            store = self.plane.store
            if store.try_get("ResourceClaim", self.CLAIM) is None:
                self.plane.submit(self.plane.planner.make_claim(self.CLAIM, n))
                self.plane.submit(
                    Workload(claim=self.CLAIM, axes=axes,
                             placement=self.placement, build_mesh=False),
                    name=self.WORKLOAD)
            else:
                # elastic resize IS a spec edit; reconcilers do the rest
                self.plane.edit("ResourceClaim", self.CLAIM,
                                lambda c: setattr(c.spec.requests[0],
                                                  "count", n))
                self.plane.edit("Workload", self.WORKLOAD,
                                lambda w: setattr(w, "axes", axes))
        self.plane.wait_for("Workload", self.WORKLOAD)
        self.events.append(f"planned {data}x{model}")
        return self.plan

    # -- failure handling -----------------------------------------------------
    def _evict_node(self, node: str) -> None:
        """Remove ``node`` from the schedulable world.

        With a node plane the eviction is the *lifecycle* path: kill the
        agent, force-expire its lease, and wait for the
        NodeLifecycleController to withdraw the inventory — the same
        road a silent agent death takes, minus the detection window.
        Without one it is the direct pool withdrawal, as before.
        """
        if self.node_plane is not None and node in self.node_plane.agents:
            self.node_plane.fail_node(node)
            if self.reconcile_mode == "inline":
                self.plane.reconcile()
            else:
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline:
                    obj = self.plane.store.try_get("Node", node)
                    done = (obj is None
                            or not obj.is_true(CONDITION_READY, current=True))
                    if done and not any(s.node == node for s in
                                        self.registry.pool.slices):
                        return
                    time.sleep(0.01)
                raise RuntimeError(
                    f"node {node} was not evicted within 10s")
        else:
            with self.plane.mutate():
                self.registry.pool.withdraw_node(node)

    def on_node_failed(self, event: Event) -> Dict[str, Any]:
        node = event.context["node"]
        self.events.append(f"node_failed {node}")
        return self._handle_node_failure(node)

    def _handle_node_failure(self, node: str) -> Dict[str, Any]:
        # evict the node (lifecycle path or direct withdrawal); the
        # reconcilers see the lost devices + the shrunk spec and
        # converge on a survivor mesh
        self._evict_node(node)
        plan = self.plan_mesh()
        self.registry.bus.publish(Events.JOB_RESUMED,
                                  plan=plan, reason=f"lost {node}")
        return {"replanned": plan.summary()}

    def on_straggler(self, event: Event) -> Optional[Dict[str, Any]]:
        # policy: persistent stragglers ARE failures. The telemetry
        # driver publishes the event; strikes accumulate per host (or in
        # the 'unknown' bucket when the event carries no host) and are
        # persisted on the workload so WAL recovery resumes the count.
        step = event.context.get("step")
        host = str(event.context.get("host") or event.context.get("node")
                   or "")
        key = host or "unknown"
        self.strikes[key] = self.strikes.get(key, 0) + 1
        count = self.strikes[key]
        self.events.append(f"straggler at step {step} "
                           f"({key}: strike {count})")
        if host and count >= self.straggler_strike_limit:
            self.events.append(
                f"straggler escalation: {host} struck out "
                f"({count}/{self.straggler_strike_limit}), treating as failed")
            self.strikes.pop(key, None)
            self._persist_strikes()
            return self._handle_node_failure(host)
        self._persist_strikes()
        return {"strikes": count, "host": key}

    def _persist_strikes(self) -> None:
        """Strike counts ride the workload status through the WAL."""
        if self.plane.store.try_get("Workload", self.WORKLOAD) is None:
            return
        snapshot = dict(self.strikes)
        self.plane.store.update_status(
            "Workload", self.WORKLOAD,
            lambda st: st.outputs.__setitem__("straggler_strikes", snapshot))
        if self.plane.journal is not None:
            self.plane.journal.maybe_flush()

    # -- introspection ------------------------------------------------------
    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        plan = self.plan
        assert plan is not None
        return plan.axis_shape


# ---------------------------------------------------------------------------
# The elastic run on gloo ranks (private: shared by the tests and
# chip_smoke.py; no entry point of its own)
# ---------------------------------------------------------------------------


def _plan_host(ctl: ElasticController, plan: core.MeshPlan) -> str:
    """The host of the plan's first chip (mesh coordinate order)."""
    first = min(plan.attachment().bindings, key=lambda b: b.mesh_coord)
    return ctl.cluster.fabric.component(first.device_id).attrs["host"]


def _train_rank(job_path: str, rank: int) -> None:
    """One gloo rank of ``job_path``'s process group: build the mesh of
    the job's attachment, train the job's smoke config under the
    sharding rules (from the newest checkpoint of the job's
    ``ckpt_dir``, else from the port's init at seed 0), leave the group,
    and write ``rank<r>.json`` beside the job."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ..api.persistence import decode
    from ..ckpt.checkpoint import CheckpointManager
    from ..configs.registry import smoke_config
    from ..data.pipeline import SyntheticLMData
    from ..parallel.sharding import ShardingRules, use_rules
    from ..train.optimizer import AdamW
    from ..train.schedule import constant_schedule
    from ..train.train_step import StepConfig
    from ..train.trainer import FaultInjector, Trainer
    from ..tree import tree_leaves

    with open(job_path) as f:
        job = json.load(f)
    torch.set_num_threads(1)
    spec = decode(job["attachment"])
    world = math.prod(spec.axis_shape)
    dist.init_process_group("gloo", init_method=f"file://{job['rendezvous']}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=job["timeout_s"]))
    try:
        mesh = core.MeshRuntime("cpu").execute(spec)
        cfg = smoke_config(job["arch"]).replace(**job["overrides"])
        opt = AdamW(constant_schedule(1e-3))
        ckpt = CheckpointManager(job["ckpt_dir"])
        drivers = ([FaultInjector(fail_at=job["fail_at"], node=job["node"])]
                   if job["fail_at"] is not None else [])
        trainer = Trainer(cfg, opt, SyntheticLMData(cfg, job["batch"], job["seq"]),
                          ckpt=ckpt, ckpt_every=job["ckpt_every"], drivers=drivers,
                          step_cfg=StepConfig(remat="dots"), device="cpu")
        resumed = None
        with use_rules(ShardingRules(mesh=mesh)):
            if ckpt.latest_step() is not None:
                resumed = trainer.resume()
            else:
                trainer.init(0)
            out = trainer.fit(job["steps"])
        # a stopped fit returns before joining the step's async save:
        # every rank joins it here (its barrier), then leaves the group
        ckpt.wait()
        leaves = (tree_leaves(trainer.state["params"])
                  + tree_leaves(trainer.state["opt_state"]))
        report = {"rank": rank, "world": world, "result": out,
                  "resumed_from": resumed,
                  "mesh": [list(mesh.mesh_dim_names), mesh.mesh.tolist()],
                  "steps": [h["step"] for h in trainer.history],
                  "losses": [h["loss"] for h in trainer.history],
                  "all_dtensor": all(isinstance(t, DTensor) and t.device_mesh is mesh
                                     for t in leaves)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(os.path.dirname(job_path), f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


def _run_ranks(job: Dict[str, Any], plan: core.MeshPlan, work: str,
               timeout_s: float) -> List[Dict[str, Any]]:
    """Run ``job`` on one gloo rank per binding of ``plan``'s attachment
    (fresh rendezvous under ``work``); returns the ranks' reports. A
    failed rank stops the others (they would wait in a collective), and
    so does the timeout."""
    from ..api.persistence import encode

    os.makedirs(work, exist_ok=True)
    spec = plan.attachment()
    job_path = os.path.join(work, "job.json")
    with open(job_path, "w") as f:
        json.dump({**job, "attachment": encode(spec), "timeout_s": timeout_s,
                   "rendezvous": os.path.join(work, "rdzv")}, f)
    code = ("import sys; from repro_torch.launch.elastic import _train_rank; "
            "_train_rank(sys.argv[1], int(sys.argv[2]))")
    world = len(spec.bindings)
    _ranks.spawn(lambda r: [sys.executable, "-c", code, job_path, str(r)],
                 world, work, timeout_s, "elastic")
    reports = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def _train_elastic(ctl: ElasticController, job: Dict[str, Any], work: str,
                   fail_at: int = 5, resume_steps: int = 3,
                   timeout_s: float = RANK_TIMEOUT_S) -> Dict[str, Any]:
    """Train ``job`` on the controller's plan as gloo ranks until every
    rank's ``FaultInjector`` stops it at ``fail_at`` (the failed node: a
    host of the plan), publish NODE_FAILED on the controller's bus, and
    resume the survivors from the newest checkpoint on the re-planned,
    smaller mesh for ``resume_steps`` steps.

    ``job``: ``arch`` (its smoke config), ``overrides`` (ModelConfig
    fields), ``batch``, ``seq``, ``steps`` (the first run's fit),
    ``ckpt_dir``, ``ckpt_every``; AdamW at a constant 1e-3, remat dots.
    The first run starts from the newest checkpoint of ``ckpt_dir`` (a
    step-0 checkpoint of given weights), else from the port's init at
    seed 0. Returns both plans,
    both runs' rank reports, the failed node and the seconds from
    NODE_FAILED to the re-planned Ready."""
    plan = ctl.plan or ctl.plan_mesh()
    node = _plan_host(ctl, plan)
    first = _run_ranks({**job, "fail_at": fail_at, "node": node},
                       plan, os.path.join(work, "first"), timeout_s)
    t = time.perf_counter()
    failed = [r for r in ctl.registry.bus.publish(Events.NODE_FAILED, node=node)
              if not r.ok]
    replan_s = time.perf_counter() - t
    if failed:      # the bus isolates a handler's error: raise it here
        raise RuntimeError(f"NODE_FAILED {node}: " + "; ".join(
            f"{r.driver}: {r.error}" for r in failed))
    survivors = ctl.plan
    second = _run_ranks({**job, "fail_at": None, "node": None,
                         "steps": resume_steps},
                        survivors, os.path.join(work, "survivors"), timeout_s)
    return {"node": node, "plans": [plan.summary(), survivors.summary()],
            "shapes": [list(plan.axis_shape), list(survivors.axis_shape)],
            "first": first, "survivors": second, "replan_s": replan_s}

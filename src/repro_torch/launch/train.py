"""Training driver: the NRI-driven Trainer, on a KND-planned mesh if asked.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ck --ckpt-every 10
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ck --resume
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 4 --batch 8 --seq 32 --mesh 2x2 --devices 4 \
      --state-dir /tmp/train-state --node-plane

AdamW on a cosine schedule (warmup ``steps // 20``), as the JAX
package's ``launch/train.py``; ``--resume`` restores the newest committed
checkpoint of ``--ckpt-dir`` and trains ``--steps`` more. ``--device``
defaults to the GPU, where attention runs through the flash kernel when
it is built for the config's head dim (else the plain "auto" choice, as
on the CPU). ``--layers`` cuts the config's depth (the port's own flag;
0 keeps it).

With ``--mesh DxM`` the full KND workflow runs declaratively first: a
ResourceClaim and a Workload are submitted to the control plane, its
reconcilers allocate, prepare and attach them, and the AttachmentController
builds the ``DeviceMesh`` (``MeshRuntime.execute``, on an informer thread
under ``--reconcile-mode threaded``); training then runs under
``ShardingRules(mesh=...)`` read off the workload's ``outputs["mesh"]``.
An existing ``--state-dir`` is recovered and its claim and workload
adopted; a checkpoint's co-saved store (``--resume`` without a state
directory) is adopted likewise. Checkpoints of the sharded state are
gathered on every rank and written by rank 0, in the JAX package's
format.

``--devices N`` is the world size of the process group the mesh lives
on (0: the initialised group's, else 1). On the CPU the launcher starts
N gloo ranks itself, each a process running this launcher; on the GPU N
must be the number of visible cards, and only one card is driven. Every
rank runs its own control plane (its own reconcilers, mesh build and node
agents); rank 0 alone recovers and journals to ``--state-dir``, reports
and prints, so no two processes append to one WAL. The other ranks start
from rank 0's store (recovered, adopted or fresh: broadcast before any
plane thread starts), and once every workload is Ready the ranks' plans
and attachments are compared with rank 0's: a rank that would build
another mesh raises. Between the two, a rank makes no collective while
it waits for its workload: the only process-group calls are the mesh
build's, which every rank makes once, in the same order.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional

RANK_TIMEOUT_S = 1800      # how long the CPU launcher waits for its ranks
REDERIVE_TIMEOUT_S = 600   # as ControlPlane.wait_for's informer wait


def _spawn_ranks(argv: List[str], world: int) -> Dict[str, Any]:
    """Run this launcher on ``world`` gloo ranks (one process each, file
    rendezvous); relays rank 0's output and returns its report."""
    work = tempfile.mkdtemp(prefix="repro-torch-train-")
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    paths = [os.path.join(work, f"rank{r}.log") for r in range(world)]
    procs = []
    for r, path in enumerate(paths):
        with open(path, "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *argv,
                 "--rank", str(r), "--rendezvous", os.path.join(work, "rdzv")],
                stdout=out, stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        # a failed rank leaves the others waiting in a collective: stop
        # them all as soon as one fails
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for path in paths:
        with open(path, "rb") as f:
            logs.append(f.read().decode(errors="replace"))
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"train ranks {failed} failed:\n" + "\n".join(
            f"--- rank {r}\n{logs[r][-4000:]}" for r in failed))
    sys.stdout.write(logs[0])
    with open(os.path.join(work, "rdzv.report.json")) as f:
        return json.load(f)


def attention_impl(cfg, device) -> str:
    """The training step's attention: the flash kernel on the card when
    it is built for the config's head dim, else the plain "auto" choice."""
    from ..kernels.flash_attention.flash_attention import HEAD_DIMS
    return ("kernel" if device.type == "cuda"
            and cfg.resolved_head_dim in HEAD_DIMS else "auto")


def _mesh_plane(args, d: int, m: int, rank: int, device_type: str):
    """The declarative KND workflow for a ``d x m`` mesh -> (plane,
    workload object, informer runtime or None, node plane or None)."""
    import torch.distributed as dist

    from .. import core
    from ..api import (ControlPlane, ControlPlaneRuntime, Workload,
                       dump_store, has_state, load_store)
    from ..api.persistence import encode
    from ..ckpt.checkpoint import load_store_dump
    from ..topology.tpu import TpuPodSpec, build_tpu_cluster

    say = print if rank == 0 else None
    world = d * m
    # a pod big enough for the grid: submit claim + workload, wait for
    # Ready, read the mesh off the workload's status
    side = max(d, m)
    cluster = build_tpu_cluster(1, TpuPodSpec(x=side, y=side))
    reg = core.DriverRegistry()
    reg.add(core.TpuDriver(cluster)).add(core.IciDriver(cluster))
    runtime = core.MeshRuntime(device_type)
    plane = None
    if rank == 0:
        dump = (load_store_dump(args.ckpt_dir)
                if args.resume and args.ckpt_dir
                and not (args.state_dir and has_state(args.state_dir))
                else None)
        if dump is not None:
            # no WAL, but the checkpoint carries the network state
            plane = ControlPlane(reg, cluster, store=load_store(dump),
                                 runtime=runtime, state_dir=args.state_dir)
            stats = plane.adopt()
            say(f"[knd] adopted checkpointed store "
                f"v{dump['resource_version']}: {stats}")
        else:
            # kill-and-resume: an existing state dir is recovered and its
            # in-flight workload adopted
            plane = ControlPlane.open(args.state_dir, reg, cluster,
                                      announce=say, runtime=runtime)
    if world > 1:
        # every rank plans from rank 0's state, before any thread starts
        box = [dump_store(plane.store) if rank == 0 else None]
        dist.broadcast_object_list(box, src=0)
        if rank != 0:
            plane = ControlPlane(reg, cluster, store=load_store(box[0]),
                                 runtime=runtime)
            plane.adopt()
    node_plane = informer = None
    if args.node_plane:
        # agents register BEFORE the informer starts: recovered Nodes
        # hold stale leases and must re-heartbeat first, else the
        # lifecycle controller would evict adopted claims
        from ..node import NodePlane
        node_plane = NodePlane(plane).start()
        if say:
            say(f"[knd] node plane: {len(node_plane.agents)} agent(s), "
                f"scheduler placing claims onto nodes")
    if args.reconcile_mode == "threaded":
        # the informer threads keep reconciling (and journaling) while
        # the training steps execute; they touch no tensor
        informer = ControlPlaneRuntime(plane).start()
    # declarative spec reconciliation: a recovered run with changed flags
    # converges onto the new intent as spec edits
    claim_obj = plane.store.try_get("ResourceClaim", "train")
    if claim_obj is None:
        plane.submit(plane.planner.make_claim("train", d * m))
    elif claim_obj.spec.spec.requests[0].count != d * m:
        plane.edit("ResourceClaim", "train",
                   lambda c: setattr(c.spec.requests[0], "count", d * m))
    axes = [core.AxisSpec("data", d, "y"), core.AxisSpec("model", m, "x")]
    wl_obj = plane.store.try_get("Workload", "train-job")
    if wl_obj is None:
        plane.submit(Workload(claim="train", placement=args.placement,
                              axes=axes, seed=args.seed),
                     name="train-job")
    elif (list(wl_obj.spec.axes) != axes
          or wl_obj.spec.placement != args.placement
          or wl_obj.spec.seed != args.seed):
        def retarget(w):
            w.axes, w.placement, w.seed = axes, args.placement, args.seed
        plane.edit("Workload", "train-job", retarget)
    wl = plane.wait_for("Workload", "train-job")
    # a recovered workload is Ready from before the restart while its plan
    # and mesh, never persisted, are re-derived on an informer thread
    deadline = time.monotonic() + REDERIVE_TIMEOUT_S
    while "mesh" not in wl.status.outputs:
        if time.monotonic() > deadline:
            raise TimeoutError(f"Workload/train-job is Ready but its mesh "
                               f"was not re-derived in {REDERIVE_TIMEOUT_S}s")
        time.sleep(0.01)
        wl = plane.store.get("Workload", "train-job")
    if world > 1:
        # the ranks' meshes must be one mesh: the same plan and bindings
        plan = wl.status.outputs["plan"]
        mine = (plan.summary(), json.dumps(encode(plan.attachment()),
                                           sort_keys=True))
        seen: List[Any] = [None] * world
        dist.all_gather_object(seen, mine)
        differ = [r for r, s in enumerate(seen) if s != seen[0]]
        if differ:
            raise RuntimeError(f"ranks {differ} planned another mesh than "
                               f"rank 0: {seen[differ[0]][0]} against "
                               f"{seen[0][0]}")
    return plane, wl, informer, node_plane


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0 = its own)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--state-dir", default=None,
                    help="control-plane state directory (WAL + snapshots); "
                         "an existing one is recovered and its in-flight "
                         "workload adopted instead of re-allocated")
    ap.add_argument("--devices", type=int, default=0,
                    help="world size of the mesh's process group (0 = the "
                         "initialised group's, else 1); on the CPU the "
                         "launcher starts that many gloo ranks")
    ap.add_argument("--mesh", default=None,
                    help="DxM data x model shape, e.g. 2x2 (D*M ranks)")
    ap.add_argument("--placement", default="aligned",
                    choices=["aligned", "unaligned"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reconcile-mode", default="threaded",
                    choices=["threaded", "inline"],
                    help="threaded: background informer runtime keeps "
                         "converging while training steps execute "
                         "(default); inline: blocking reconcile() "
                         "reference arm")
    ap.add_argument("--node-plane", action="store_true",
                    help="run per-node agents (repro_torch.node): slices "
                         "are published per host under heartbeat leases, "
                         "claims are placed by the topology scheduler, "
                         "and a dead agent is evicted + rescheduled")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    # set by the CPU launcher for the ranks it starts
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..device import resolve_device

    device = resolve_device(args.device)
    grouped = dist.is_available() and dist.is_initialized()
    world = args.devices or (dist.get_world_size() if grouped else 1)
    if grouped and world != dist.get_world_size():
        raise ValueError(f"--devices {world}: the initialised process group "
                         f"has {dist.get_world_size()} ranks")
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if args.devices and args.devices != visible:
            raise ValueError(f"--devices {args.devices}: {visible} card(s) "
                             f"are visible")
        if world > 1:
            raise NotImplementedError(
                f"{world} ranks on the GPU: the launcher drives one card")
    elif world > 1 and not grouped and args.rank is None:
        return _spawn_ranks(list(sys.argv[1:] if argv is None else argv),
                            world)
    d = m = 0
    if args.mesh:
        d, m = (int(x) for x in args.mesh.split("x"))
        if d * m != world:
            raise ValueError(f"--mesh {args.mesh} needs {d * m} ranks; the "
                             f"process group has {world}")

    from ..ckpt.checkpoint import CheckpointManager
    from ..configs.registry import get_config, smoke_config
    from ..core.nri import Events
    from ..data.pipeline import SyntheticLMData
    from ..parallel.sharding import ShardingRules, use_rules
    from ..train.optimizer import AdamW
    from ..train.schedule import cosine_schedule
    from ..train.train_step import StepConfig
    from ..train.trainer import Trainer

    created = False
    if args.mesh and not grouped:
        if device.type == "cuda":
            # the main thread owns the card: the mesh, built on an
            # informer thread, then leaves the current device alone
            torch.cuda.set_device(device.index or 0)
        init = args.rendezvous or os.path.join(
            tempfile.mkdtemp(prefix="repro-torch-train-"), "rdzv")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"file://{init}",
                                rank=args.rank or 0, world_size=world)
        created = True
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers:
        cfg = cfg.replace(num_layers=args.layers)
    data = SyntheticLMData(cfg, global_batch=args.batch, seq_len=args.seq,
                           seed=args.seed)
    opt = AdamW(cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps))
    sc = StepConfig(microbatches=args.microbatches, remat=args.remat,
                    attention_impl=attention_impl(cfg, device))

    rules = plane = informer = node_plane = None
    knd: Optional[Dict[str, Any]] = None
    if args.mesh:
        from ..api import allocation_records
        plane, wl, informer, node_plane = _mesh_plane(args, d, m, rank,
                                                      device.type)
        plan = wl.status.outputs["plan"]
        mesh = wl.status.outputs["mesh"]
        rules = ShardingRules(mesh=mesh)
        lat = wl.status.outputs["phase_latency_s"]
        if rank == 0:
            print(f"[knd] {plan.summary()}  "
                  f"(submit->Ready {lat['total'] * 1e3:.1f}ms)")
        knd = {"plan": plan.summary(),
               "submit_to_ready_ms": round(lat["total"] * 1e3, 2),
               "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
               "allocation_records": allocation_records(plane.store),
               "adopted": getattr(plane, "adoption_stats", None)}

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt is not None and plane is not None:
        # co-checkpoint the network state next to the model state
        from ..api import dump_store
        ckpt.store_provider = lambda: dump_store(plane.store)
    trainer = Trainer(cfg, opt, data, step_cfg=sc, ckpt=ckpt,
                      ckpt_every=args.ckpt_every, device=device)
    grad_norms = []           # read back after the fit: no sync per step
    trainer.bus.subscribe(
        Events.STEP_END,
        lambda e: grad_norms.append(e.context["metrics"]["grad_norm"]),
        "launcher")

    with use_rules(rules):
        if args.resume and ckpt is not None and ckpt.latest_step() is not None:
            step = trainer.resume()
            if rank == 0:
                print(f"[resume] from step {step}")
        else:
            trainer.init(args.seed)
        t0 = time.time()
        out = trainer.fit(args.steps)
        dt = time.time() - t0

    if informer is not None:
        stats = informer.stop()
        knd["informer"] = {"reconciled": stats.reconciled,
                           "rounds": stats.informer_rounds,
                           "panics": stats.panics}
        if rank == 0:
            print(f"[knd] informer runtime stopped after training: "
                  f"{stats.reconciled} reconciles over "
                  f"{stats.informer_rounds} rounds, {stats.panics} panics")
    if node_plane is not None:
        node_plane.stop()
    if plane is not None and plane.journal is not None:
        plane.journal.close()   # a later run in this process recovers it

    losses = [h["loss"] for h in trainer.history]
    report = {
        "arch": cfg.name, "device": str(device), "result": out,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "steps_per_s": round(len(losses) / dt, 3) if dt > 0 else None,
        "losses": losses, "grad_norms": [float(g) for g in grad_norms],
    }
    if knd is not None:
        report["knd"] = knd
    if created:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(report, indent=1))
        if args.rendezvous:
            with open(args.rendezvous + ".report.json", "w") as f:
                json.dump(report, f)
    return report


if __name__ == "__main__":
    main()

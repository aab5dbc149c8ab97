"""Serving driver: continuous batching through the ServeEngine/Router.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --requests 8 --new-tokens 16
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --claim-chips 2 --state-dir /tmp/serve-state --node-plane

Requests go through the front-end :class:`~repro_torch.serve.router.
Router` over ``--replicas`` engine replicas (load-aware dispatch,
bounded per-replica queues); the report carries the SLO tracker's
measured TTFT/TPOT percentiles. ``--device`` defaults to the GPU.

With ``--claim-chips N`` the serve replica set is provisioned
declaratively first, as in the JAX package's launcher: a
ResourceClaimTemplate + a serve Workload are submitted to the API store,
the WorkloadController stamps one claim per replica slot, and serving
starts once the workload's Ready condition is True. Router replicas are
then named after the stamped claims, and the SLO snapshot is published
back into the workload's ``outputs["slo"]`` on the main thread, after
the router has drained. The informer and node-agent threads touch no
tensor: every CUDA call stays on the main thread.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from typing import Any, Dict, List, Optional


def provision_replicas(slots: int, chips_per_replica: int,
                       state_dir: Optional[str] = None,
                       reconcile_mode: str = "threaded",
                       node_plane: bool = False):
    """Declarative serve replica set -> (plane, workload ApiObject).

    With ``state_dir``, an existing WAL is recovered first: the stamped
    replica claims are adopted with their allocations intact and the
    workload only converges on a *delta* (e.g. a changed ``slots``).

    ``reconcile_mode="threaded"`` (default) starts a
    :class:`~repro_torch.api.runtime.ControlPlaneRuntime` whose informer
    threads keep reconciling while the serve engine runs; it is left
    running on ``plane.informer`` and the caller stops it.

    ``node_plane=True`` runs per-node agents: replica claims are placed
    by the topology scheduler. The started
    :class:`~repro_torch.node.NodePlane` is reachable as
    ``plane.registry.node_plane``; the caller stops it.
    """
    from .. import core
    from ..api import ControlPlane, ControlPlaneRuntime, Workload
    from ..topology.tpu import TpuPodSpec, build_tpu_cluster

    need = slots * chips_per_replica
    side = max(2, 2 * math.ceil(math.sqrt(need) / 2))  # even torus side
    cluster = build_tpu_cluster(1, TpuPodSpec(x=side, y=side))
    reg = core.DriverRegistry()
    reg.add(core.TpuDriver(cluster)).add(core.IciDriver(cluster))
    plane = ControlPlane.open(state_dir, reg, cluster)
    if node_plane:
        from ..node import NodePlane
        NodePlane(plane).start()     # agents first (fresh leases), then
    if reconcile_mode == "threaded":  # the informer
        ControlPlaneRuntime(plane).start()   # reachable as plane.informer

    if plane.store.try_get("ResourceClaimTemplate", "serve-replica") is None:
        plane.submit(core.ResourceClaimTemplate(
            name="serve-replica",
            spec=core.ClaimSpec(
                requests=[core.DeviceRequest(
                    name="chips", device_class="tpu.google.com",
                    count=chips_per_replica)],
                topology_scope="cluster")))
    wl_obj = plane.store.try_get("Workload", "serve")
    if wl_obj is None:
        plane.submit(Workload(claim_template="serve-replica", role="serve",
                              replicas=slots),
                     name="serve")
    elif wl_obj.spec.replicas != slots:
        # resize of a recovered replica set is a spec edit, as ever
        plane.edit("Workload", "serve",
                   lambda w: setattr(w, "replicas", slots))
    wl = plane.wait_for("Workload", "serve")
    return plane, wl


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind the front-end Router")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens fed per engine tick while a "
                         "slot catches up (1 = token-by-token)")
    ap.add_argument("--max-queue", type=int, default=8,
                    help="per-replica router queue bound (backpressure)")
    ap.add_argument("--claim-chips", type=int, default=0,
                    help="chips per replica slot; >0 provisions the "
                         "replica set through the declarative control plane")
    ap.add_argument("--state-dir", default=None,
                    help="control-plane state directory; recovered replica "
                         "claims are adopted instead of re-stamped")
    ap.add_argument("--reconcile-mode", default="threaded",
                    choices=["threaded", "inline"],
                    help="threaded: informer runtime converges replica "
                         "sets while the engine decodes (default); "
                         "inline: blocking reference arm")
    ap.add_argument("--node-plane", action="store_true",
                    help="run per-node agents; replica claims are "
                         "scheduler-placed and survive node death")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    knd = None
    plane = None
    if args.claim_chips > 0:
        plane, wl = provision_replicas(args.slots, args.claim_chips,
                                       state_dir=args.state_dir,
                                       reconcile_mode=args.reconcile_mode,
                                       node_plane=args.node_plane)
        lat = wl.status.outputs["phase_latency_s"]
        claims = wl.status.outputs["claims"]
        print(f"[knd] serve replica set Ready: {len(claims)} claims "
              f"({args.claim_chips} chips each) in {lat['total'] * 1e3:.1f}ms")
        knd = {"replica_claims": claims,
               "submit_to_ready_ms": round(lat["total"] * 1e3, 2)}

    import numpy as np

    from ..configs.registry import get_config, smoke_config
    from ..device import resolve_device
    from ..models import lm
    from ..serve.engine import ServeEngine
    from ..serve.router import Router, RouterOverloadError
    from ..serve.slo import SloTracker

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = lm.init_params(cfg, args.seed, device)

    slo = SloTracker()
    router = Router(slo, max_queue_per_replica=args.max_queue)
    replica_names = (knd["replica_claims"][:args.replicas] if knd else
                     [f"replica-{i}" for i in range(args.replicas)])
    for i, name in enumerate(replica_names):
        router.add_replica(name, ServeEngine(
            cfg, params, batch_slots=args.slots, max_len=args.max_len,
            seed=args.seed + i, prefill_chunk=args.prefill_chunk,
            device=device))

    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    finished = []
    for _ in range(args.requests):
        prompt = rng.randint(0, cfg.vocab_size, size=args.prompt_len).tolist()
        try:
            router.submit(prompt, args.new_tokens, args.temperature)
        except RouterOverloadError:
            finished.extend(router.run())   # drain, then retry once
            router.submit(prompt, args.new_tokens, args.temperature)
    finished.extend(router.run())
    dt = time.time() - t0
    done = [r for r in finished if r.done]
    failures = [r for r in finished if r.failed]
    total_tokens = sum(len(r.generated) for r in done)
    baseline = slo.arm_snapshot("baseline")
    out = {
        "arch": cfg.name,
        "device": str(device),
        "replicas": len(replica_names),
        "completed": len(done),
        "failed": len(failures),
        "generated_tokens": total_tokens,
        "tokens_per_s": round(total_tokens / dt, 2) if dt > 0 else None,
        "p50_ttft_ms": round(baseline["p50_ttft_ms"], 2),
        "p95_ttft_ms": round(baseline["p95_ttft_ms"], 2),
        "p50_tpot_ms": round(baseline["p50_tpot_ms"], 2),
        "p95_tpot_ms": round(baseline["p95_tpot_ms"], 2),
        "dispatch": router.dispatched,
        "sample": done[0].generated[:8] if done else [],
    }
    if knd is not None:
        out["knd"] = knd
    if plane is not None:
        # the serve plane's real latencies become the workload's SLO
        # status — the surface canary verdicts are judged against
        slo.publish(plane, "serve")
    if plane is not None and plane.informer is not None:
        stats = plane.informer.stop()       # informers ran under the engine
        out["knd"]["informer"] = {"reconciled": stats.reconciled,
                                  "rounds": stats.informer_rounds}
    if plane is not None and plane.registry.node_plane is not None:
        plane.registry.node_plane.stop()
    if plane is not None and plane.journal is not None:
        plane.journal.close()   # a later run in this process recovers it
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

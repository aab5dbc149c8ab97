"""Serving driver: continuous batching through the ServeEngine/Router.

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
      --requests 8 --new-tokens 16

Requests go through the front-end :class:`~repro_torch.serve.router.
Router` over ``--replicas`` engine replicas (load-aware dispatch,
bounded per-replica queues); the report carries the SLO tracker's
measured TTFT/TPOT percentiles. ``--device`` defaults to the GPU.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional


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
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

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
    replica_names = [f"replica-{i}" for i in range(args.replicas)]
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
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()

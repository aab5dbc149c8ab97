"""Training driver: the NRI-driven Trainer with checkpoints and resume.

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ck --ckpt-every 10
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
      --steps 20 --batch 8 --seq 64 --ckpt-dir /tmp/ck --resume

AdamW on a cosine schedule (warmup ``steps // 20``), as the JAX
package's ``launch/train.py``; ``--resume`` restores the newest committed
checkpoint of ``--ckpt-dir`` and trains ``--steps`` more. ``--device``
defaults to the GPU. The JAX launcher's control-plane flags (mesh
planning, the state directory, node agents, observability) are not
ported yet.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="dots", choices=["none", "dots", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    args = ap.parse_args(argv)

    from ..ckpt.checkpoint import CheckpointManager
    from ..configs.registry import get_config, smoke_config
    from ..data.pipeline import SyntheticLMData
    from ..device import resolve_device
    from ..train.optimizer import AdamW
    from ..train.schedule import cosine_schedule
    from ..train.train_step import StepConfig
    from ..train.trainer import Trainer

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    data = SyntheticLMData(cfg, global_batch=args.batch, seq_len=args.seq,
                           seed=args.seed)
    opt = AdamW(cosine_schedule(args.lr, max(args.steps // 20, 1), args.steps))
    sc = StepConfig(microbatches=args.microbatches, remat=args.remat)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    trainer = Trainer(cfg, opt, data, step_cfg=sc, ckpt=ckpt,
                      ckpt_every=args.ckpt_every, device=device)

    if args.resume and ckpt is not None and ckpt.latest_step() is not None:
        step = trainer.resume()
        print(f"[resume] from step {step}")
    else:
        trainer.init(args.seed)
    t0 = time.time()
    out = trainer.fit(args.steps)
    dt = time.time() - t0

    losses = [h["loss"] for h in trainer.history]
    report = {
        "arch": cfg.name, "device": str(device), "result": out,
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "steps_per_s": round(len(losses) / dt, 3) if dt > 0 else None,
    }
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()

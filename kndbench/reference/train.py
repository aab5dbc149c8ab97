"""The reference's training steps: the plain model's loss, its gradient,
global-norm clipping and AdamW, in float32.

The step follows the configuration the cell states: the mean cross
entropy over every position of the batch, the gradient clipped to a
global norm of ``clip_norm``, AdamW (bias-corrected moments; weight
decay on every leaf of two or more dims, as the optimizer is configured
on the stacked tree) at the cosine schedule's rate, and the parameters
held between steps in the dtype the configuration stores them in
(bf16), rounded after each update. The batch's rows go through one at a
time (the loss weighted by its share of the rows), each layer
checkpointed, so that full-width models fit on one card.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import model as ref

F32 = torch.float32


def cosine_lr(step: int, peak_lr: float, warmup_steps: int, total_steps: int,
              final_frac: float = 0.1) -> float:
    """Linear warmup to ``peak_lr``, then a cosine down to ``final_frac``
    of it at ``total_steps``; f32 arithmetic as the schedule's."""
    t = torch.tensor(float(step), dtype=F32)
    warm = peak_lr * torch.clamp(t / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((t - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * frac))
    return float(warm if step < warmup_steps else peak_lr * cos)


def _flat(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, p) if isinstance(v, dict) else {p: v})
    return out


def train(m: Dict, job: Dict, weights: Dict, batches: List[Dict[str, torch.Tensor]],
          prec: str = "f32") -> Dict:
    """``len(batches)`` steps from ``weights``; returns each step's loss,
    the per-leaf norms of the first step's clipped gradient, and the
    per-leaf norms of the parameters' change over all the steps."""
    if prec == "f32":
        ref.no_tf32()
    params = ref.f32_tree(weights, requires_grad=True)
    flat = _flat(params)
    stored = {k: v.dtype for k, v in _flat(weights).items()}
    start = {k: v.detach().clone() for k, v in flat.items()}
    opt = job["adamw"]
    sched = job["schedule"]
    mom = {k: torch.zeros_like(v) for k, v in flat.items()}
    vel = {k: torch.zeros_like(v) for k, v in flat.items()}
    losses, first_grad = [], {}
    for step, batch in enumerate(batches):
        rows = batch["tokens"].shape[0]
        total = 0.0
        for r in range(rows):
            lo = ref.loss(m, params, batch["tokens"][r:r + 1], batch["labels"][r:r + 1], prec)
            (lo / rows).backward()
            total += float(lo.detach()) / rows
        losses.append(total)
        grads = {k: v.grad.detach() for k, v in flat.items()}
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        scale = torch.clamp(job["clip_norm"] / torch.clamp(norm, min=1e-9), max=1.0)
        lr = cosine_lr(step, sched["peak_lr"], sched["warmup_steps"], sched["total_steps"])
        t = step + 1.0
        c1, c2 = 1.0 - opt["b1"] ** t, 1.0 - opt["b2"] ** t
        with torch.no_grad():
            for k, p in flat.items():
                g = grads[k] * scale
                if step == 0:
                    first_grad[k] = float(torch.linalg.vector_norm(g))
                mom[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                vel[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * g * g)
                upd = (mom[k] / c1) / (torch.sqrt(vel[k] / c2) + opt["eps"])
                if p.dim() >= 2:
                    upd = upd + opt["weight_decay"] * p
                p.copy_((p - lr * upd).to(stored[k]).to(F32))
                p.grad = None
        del grads
    change = {k: float(torch.linalg.vector_norm(flat[k].detach() - start[k]))
              for k in flat}
    return {"losses": losses, "first_grad": first_grad, "change": change}

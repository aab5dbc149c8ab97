"""The train step: microbatching, remat, clipping, optimizer update.

The port of the JAX package's ``train/train_step.py`` on one device.
Gradients come from ``torch.autograd.grad`` over the parameter leaves;
with ``microbatches > 1`` the batch is split into contiguous equal parts
and their gradients are summed in ``accum_dtype`` and divided by the
count, as JAX's scan over microbatches does. Then the
``grad_transform`` hook, global-norm clipping in f32, the optimizer and
``step + 1``. The step is functional: it returns a new state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..device import resolve_device
from ..models import lm
from ..models.config import ModelConfig
from ..tree import tree_leaves, tree_unflatten
from .optimizer import Optimizer, clip_by_global_norm

__all__ = ["StepConfig", "TrainState", "init_train_state", "make_train_step"]

TrainState = Dict[str, Any]  # {"params", "opt_state", "step"}
Batch = Dict[str, torch.Tensor]


@dataclass
class StepConfig:
    microbatches: int = 1
    remat: str = "full"            # none | dots | full
    attention_impl: str = "auto"
    clip_norm: float = 1.0
    accum_dtype: torch.dtype = torch.float32


def init_train_state(cfg: ModelConfig, optimizer: Optimizer, seed: int = 0,
                     device: Optional[torch.device] = None) -> TrainState:
    """Parameters from ``seed`` (:func:`lm.init_params`), the optimizer's
    state and step 0, on ``device`` (``None`` = the GPU)."""
    dev = resolve_device(device)
    params = lm.init_params(cfg, seed, dev)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def make_train_step(cfg: ModelConfig, optimizer: Optimizer,
                    step_cfg: Optional[StepConfig] = None,
                    grad_transform: Optional[Callable[[Any], Any]] = None):
    """Returns train_step(state, batch) -> (state, metrics).

    ``grad_transform(grads) -> grads`` runs on the averaged gradients
    before clipping. ``metrics`` holds the loss terms of
    :func:`lm.train_loss` (averaged over microbatches) and ``grad_norm``,
    the norm before clipping."""
    sc = step_cfg or StepConfig()

    def grads_of(params: Any, batch: Batch) -> Tuple[list, Dict[str, torch.Tensor]]:
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = lm.train_loss(cfg, tree_unflatten(params, live), batch,
                                      sc.attention_impl, sc.remat)
        # a parameter the batch does not reach (the projector of a
        # text-only vision batch) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def accumulated(params: Any, batch: Batch) -> Tuple[list, Dict[str, torch.Tensor]]:
        mu = sc.microbatches
        acc = [torch.zeros(p.shape, dtype=sc.accum_dtype, device=p.device)
               for p in tree_leaves(params)]
        per_mb = []
        for i in range(mu):
            mb = {k: v.reshape((mu, v.shape[0] // mu) + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()}
            grads, metrics = grads_of(params, mb)
            for a, g in zip(acc, grads):
                a.add_(g.to(sc.accum_dtype))
            del grads
            per_mb.append(metrics)
        metrics = {k: torch.stack([m[k] for m in per_mb]).mean() for k in per_mb[0]}
        return [a / mu for a in acc], metrics

    def train_step(state: TrainState, batch: Batch
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state["params"]
        if sc.microbatches > 1:
            grads, metrics = accumulated(params, batch)
        else:
            grads, metrics = grads_of(params, batch)
        grads = tree_unflatten(params, grads)
        if grad_transform is not None:
            grads = grad_transform(grads)
        grads, gnorm = clip_by_global_norm(grads, sc.clip_norm)
        new_params, new_opt = optimizer.update(params, grads, state["opt_state"],
                                               state["step"])
        metrics["grad_norm"] = gnorm
        return ({"params": new_params, "opt_state": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step

"""The train step: microbatching, remat, clipping, optimizer update.

The port of the JAX package's ``train/train_step.py`` on one device.
Gradients come from ``torch.autograd.grad`` over the parameter leaves;
with ``microbatches > 1`` the batch is split into contiguous equal parts
and their gradients are summed in ``accum_dtype`` and divided by the
count, as JAX's scan over microbatches does. Then the
``grad_transform`` hook, global-norm clipping in f32, the optimizer and
``step + 1``. The step is functional: it returns a new state.

Under sharding rules with a mesh (:func:`..parallel.sharding.use_rules`)
:func:`init_train_state` returns the parameters and the optimizer state
as ``DTensor``s placed by :func:`train_state_specs`, and the step
distributes each batch tensor over ``"batch"``; the gradients take their
parameters' placements, and the metrics come back as plain tensors, the
same on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from torch.distributed.tensor import DTensor

from ..device import resolve_device
from ..models import lm
from ..models.config import ModelConfig
from ..parallel.sharding import (active_mesh, current_rules, distribute_batch,
                                 distribute_tree, param_shardings, to_plain)
from ..tree import tree_leaves, tree_unflatten
from .optimizer import Optimizer, clip_by_global_norm

__all__ = ["StepConfig", "TrainState", "abstract_train_state", "init_train_state",
           "make_train_step", "shard_train_state", "train_state_specs"]

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
    state and step 0, on ``device`` (``None`` = the GPU). Under rules
    with a mesh every rank makes the same values and keeps its shards:
    the parameters and the optimizer state become ``DTensor``s placed by
    :func:`train_state_specs`; the step stays a plain tensor."""
    dev = resolve_device(device)
    params = lm.init_params(cfg, seed, dev)
    return shard_train_state(cfg, optimizer, {
        "params": params, "opt_state": optimizer.init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev)})


def shard_train_state(cfg: ModelConfig, optimizer: Optimizer,
                      state: TrainState) -> TrainState:
    """``state`` (the same full values on every rank) with its parameters
    and optimizer state distributed by :func:`train_state_specs` under
    the current rules' mesh; as it is without one."""
    mesh = active_mesh()
    if mesh is None:
        return state
    specs = train_state_specs(cfg, optimizer)
    abstract = abstract_train_state(cfg, optimizer)
    keys = ("params", "opt_state")
    shardings = param_shardings({k: specs[k] for k in keys}, current_rules(),
                                {k: abstract[k] for k in keys})
    return {**distribute_tree({k: state[k] for k in keys}, shardings, mesh),
            "step": state["step"]}


def abstract_train_state(cfg: ModelConfig, optimizer: Optimizer) -> TrainState:
    """The train state as ``meta`` tensors: shapes and dtypes only."""
    params = lm.abstract_params(cfg)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def train_state_specs(cfg: ModelConfig, optimizer: Optimizer) -> TrainState:
    """Logical-axis tree for the whole train state."""
    pspecs = lm.param_specs(cfg)
    return {"params": pspecs,
            "opt_state": optimizer.state_specs(pspecs, lm.abstract_params(cfg)),
            "step": ()}


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A ``DTensor`` gradient redistributed to its parameter's placements
    (autograd may hand it back replicated or as partial sums)."""
    if isinstance(g, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


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
        if active_mesh() is not None:
            batch = distribute_batch(batch, current_rules())
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        loss, metrics = lm.train_loss(cfg, tree_unflatten(params, live), batch,
                                      sc.attention_impl, sc.remat)
        # a parameter the batch does not reach (the projector of a
        # text-only vision batch) gets zeros, as jax.grad gives it
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
        return ([_placed_like(g, p) for g, p in zip(grads, live)],
                {k: to_plain(v.detach()) for k, v in metrics.items()})

    def accumulated(params: Any, batch: Batch) -> Tuple[list, Dict[str, torch.Tensor]]:
        mu = sc.microbatches
        acc = [torch.zeros_like(p, dtype=sc.accum_dtype) for p in tree_leaves(params)]
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
        metrics["grad_norm"] = to_plain(gnorm)
        return ({"params": new_params, "opt_state": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step

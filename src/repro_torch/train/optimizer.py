"""Optimizers: AdamW and factored Adafactor, with global-norm clipping.

The port of the JAX package's ``train/optimizer.py``. Both are
functional, as JAX's are: ``update`` returns new parameters and a new
state and leaves its arguments alone. Parameters may be bf16; every
update is computed in f32, and the state is f32, held in dicts shaped
like JAX's (``{"m", "v"}`` of parameter-shaped trees; ``{"acc"}`` with
``{"vr", "vc"}`` or ``{"v"}`` per parameter), so
:func:`repro_torch.convert.params_from_jax` carries JAX's optimizer
state across as it carries parameters.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch

from ..tree import tree_leaves, tree_map
from .schedule import Schedule

__all__ = ["Optimizer", "AdamW", "Adafactor", "global_norm",
           "clip_by_global_norm"]

Params = Any
F32 = torch.float32


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    leaves = tree_leaves(tree)
    total = sum(torch.sum(torch.square(x.to(F32))) for x in leaves)
    return torch.sqrt(total)


def clip_by_global_norm(tree: Params, max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    """Scale every leaf by min(1, max_norm / norm) in f32, back in the
    leaf's dtype; returns the clipped tree and the norm before clipping."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), tree), norm


def _unzip(tree: Any, n: int) -> Tuple[Any, ...]:
    """A tree whose leaves are n-tuples -> n trees."""
    def pick(node: Any, i: int) -> Any:
        if isinstance(node, dict):
            return {k: pick(v, i) for k, v in node.items()}
        return node[i]
    return tuple(pick(tree, i) for i in range(n))


class Optimizer:
    name = "optimizer"

    def init(self, params: Params) -> Any:
        raise NotImplementedError

    def update(self, params: Params, grads: Params, state: Any,
               step: torch.Tensor) -> Tuple[Params, Any]:
        raise NotImplementedError

    def state_specs(self, param_specs: Any, abstract_params: Any) -> Any:
        """The state's logical axes, from the parameters' axes and shapes."""
        raise NotImplementedError


@dataclass
class AdamW(Optimizer):
    learning_rate: Schedule
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    name: str = "adamw"

    def init(self, params: Params) -> Any:
        def f32(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": tree_map(f32, params), "v": tree_map(f32, params)}

    def update(self, params, grads, state, step):
        lr = self.learning_rate(step)
        t = step.to(F32) + 1.0
        c1 = 1.0 - self.b1 ** t
        c2 = 1.0 - self.b2 ** t

        def upd(p, g, m, v):
            g32 = g.to(F32)
            m = self.b1 * m + (1 - self.b1) * g32
            v = self.b2 * v + (1 - self.b2) * g32 * g32
            step_ = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if p.dim() >= 2:  # decay matrices only (norms/bias excluded)
                step_ = step_ + self.weight_decay * p.to(F32)
            return (p.to(F32) - lr * step_).to(p.dtype), m, v

        new_p, new_m, new_v = _unzip(
            tree_map(upd, params, grads, state["m"], state["v"]), 3)
        return new_p, {"m": new_m, "v": new_v}

    def state_specs(self, param_specs: Any, abstract_params: Any) -> Any:
        return {"m": param_specs, "v": param_specs}


@dataclass
class Adafactor(Optimizer):
    """Factored Adafactor (Shazeer & Stern, 2018), momentum-free."""

    learning_rate: Schedule
    decay: float = 0.8        # beta2 schedule: 1 - t^-decay
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    min_dim_size_to_factor: int = 128
    name: str = "adafactor"

    def _factored(self, shape) -> bool:
        return (len(shape) >= 2 and shape[-1] >= self.min_dim_size_to_factor
                and shape[-2] >= self.min_dim_size_to_factor)

    def init(self, params: Params) -> Any:
        def mk(p):
            shape = tuple(p.shape)
            if self._factored(shape):
                return {"vr": torch.zeros(shape[:-1], dtype=F32, device=p.device),
                        "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=F32,
                                          device=p.device)}
            return {"v": torch.zeros(shape, dtype=F32, device=p.device)}
        return {"acc": tree_map(mk, params)}

    def update(self, params, grads, state, step):
        lr = self.learning_rate(step)
        t = step.to(F32) + 1.0
        beta2 = 1.0 - t ** (-self.decay)

        def upd(p, g, acc):
            # each f32 temporary is dropped once used: a leaf's update
            # holds at most four of them (grok's expert leaves: 6.4 GB each)
            g32 = g.to(F32)
            g2 = g32 * g32 + self.eps
            if "vr" in acc:
                vr = beta2 * acc["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * acc["vc"] + (1 - beta2) * g2.mean(dim=-2)
                del g2
                denom = (vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=self.eps)
                         )[..., None] * vc[..., None, :]
                u = g32 * torch.rsqrt(torch.clamp(denom, min=self.eps))
                del denom
                new_acc = {"vr": vr, "vc": vc}
            else:
                v = beta2 * acc["v"] + (1 - beta2) * g2
                del g2
                u = g32 * torch.rsqrt(torch.clamp(v, min=self.eps))
                new_acc = {"v": v}
            del g32
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            p32 = p.to(F32)
            if self.weight_decay and p.dim() >= 2:
                u = u + self.weight_decay * p32
            return (p32 - lr * u).to(p.dtype), new_acc

        new_p, new_acc = _unzip(tree_map(upd, params, grads, state["acc"]), 2)
        return new_p, {"acc": new_acc}

    def state_specs(self, param_specs: Any, abstract_params: Any) -> Any:
        def spec(axes, p):
            if self._factored(tuple(p.shape)):
                return {"vr": tuple(axes[:-1]), "vc": tuple(axes[:-2]) + (axes[-1],)}
            return {"v": tuple(axes)}
        return {"acc": tree_map(spec, param_specs, abstract_params)}

"""Minimal functional module system: one builder, three interpretations.

A model is defined once as ``build_*(b: Builder, cfg)``; depending on
the builder mode the same code yields

* ``Mode.INIT``  — materialized parameter tensors on ``device``, drawn
  from one ``torch.Generator`` per parameter path (seeded from the
  builder seed and a hash of the path, so init order doesn't matter);
* ``Mode.SHAPE`` — tensors on the ``meta`` device: the tree's shapes and
  dtypes at no cost;
* ``Mode.SPEC``  — logical-axis tuples per parameter (consumed by
  ``parallel.sharding`` to derive DTensor placements).

The tree and shapes are those of the JAX package's ``Builder``; the
values are not (``jax.random`` and ``torch`` draw different numbers),
which is why parity tests always go through :mod:`repro_torch.convert`.
"""

from __future__ import annotations

import enum
import hashlib
import math
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

__all__ = ["Mode", "Builder", "LogicalAxes", "he_normal", "normal_init",
           "ones_init", "zeros_init"]

LogicalAxes = Tuple[Optional[str], ...]


class Mode(enum.Enum):
    INIT = "init"
    SHAPE = "shape"
    SPEC = "spec"


def _path_seed(path: str) -> int:
    return int.from_bytes(hashlib.blake2b(path.encode(), digest_size=4).digest(), "big")


def _randn(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.empty(shape, device=device, dtype=torch.float32).normal_(generator=gen)


# An init returns one layer's values in any floating dtype; the Builder
# casts them to the parameter's dtype. The normal inits hand back their
# f32 draw uncast, so a stacked parameter's layer is cast straight into
# its slot and no second copy of the layer is made.

def he_normal(gen, shape, dtype, device, fan_in: int):
    std = math.sqrt(2.0 / max(fan_in, 1))
    return _randn(gen, shape, device).mul_(std)


def zeros_init(gen, shape, dtype, device, fan_in=None):
    return torch.zeros(shape, dtype=dtype, device=device)


def ones_init(gen, shape, dtype, device, fan_in=None):
    return torch.ones(shape, dtype=dtype, device=device)


def normal_init(std: float):
    def f(gen, shape, dtype, device, fan_in=None):
        return _randn(gen, shape, device).mul_(std)
    return f


class Builder:
    """Walks the parameter tree, producing tensors (INIT), meta tensors
    (SHAPE) or logical axes (SPEC)."""

    def __init__(self, mode: Mode, seed: int = 0,
                 param_dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None):
        self.mode = mode
        self.seed = int(seed)
        self.param_dtype = param_dtype
        self.device = torch.device("meta") if mode == Mode.SHAPE else device
        self._scope: list = []
        self._stack: Optional[int] = None

    # -- scoping -----------------------------------------------------------
    def scope(self, name: str) -> "_Scope":
        return _Scope(self, name)

    def stacked(self, n: int) -> "_Stack":
        """Params created inside get a leading (n,) dim with logical axis
        'layer' — the stacked per-layer layout the models index one layer
        at a time."""
        return _Stack(self, n)

    @property
    def path(self) -> str:
        return "/".join(self._scope)

    # -- parameter creation ---------------------------------------------------
    def param(self, name: str, shape: Sequence[int], axes: LogicalAxes,
              init: Callable = he_normal, dtype: Optional[torch.dtype] = None,
              fan_in: Optional[int] = None) -> Union[torch.Tensor, LogicalAxes]:
        shape = tuple(int(s) for s in shape)
        if len(axes) != len(shape):
            raise ValueError(f"{self.path}/{name}: axes {axes} rank != shape {shape}")
        if self.mode == Mode.SPEC:
            return tuple(axes) if self._stack is None else ("layer",) + tuple(axes)
        dtype = dtype if dtype is not None else self.param_dtype
        if fan_in is None:
            # the default fan-in reads the unstacked shape, as in JAX
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        if self.mode == Mode.SHAPE:
            stacked = shape if self._stack is None else (self._stack,) + shape
            return torch.empty(stacked, dtype=dtype, device="meta")
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed * 2**32 + _path_seed(f"{self.path}/{name}"))
        if self._stack is None:
            return init(gen, shape, dtype, self.device, fan_in).to(dtype)
        # As JAX's vmap over the layers: each layer's init sees the
        # unstacked shape (a shape-dependent init such as the SSD's
        # log(linspace(1, 16, H)) must give every layer the same row).
        # The stack is allocated once and filled layer by layer, so the
        # peak is the stack plus one layer's draw (arctic's expert
        # weights are 8.9 GB per layer in bf16, 17.9 GB drawn in f32).
        out = torch.empty((self._stack,) + shape, dtype=dtype, device=self.device)
        for i in range(self._stack):
            out[i].copy_(init(gen, shape, dtype, self.device, fan_in))
        return out


class _Scope:
    def __init__(self, b: Builder, name: str):
        self.b = b
        self.name = name

    def __enter__(self) -> Builder:
        self.b._scope.append(self.name)
        return self.b

    def __exit__(self, *exc) -> None:
        self.b._scope.pop()


class _Stack:
    def __init__(self, b: Builder, n: int):
        self.b = b
        self.n = n
        self._prev: Optional[int] = None

    def __enter__(self) -> Builder:
        self._prev = self.b._stack
        self.b._stack = self.n
        return self.b

    def __exit__(self, *exc) -> None:
        self.b._stack = self._prev

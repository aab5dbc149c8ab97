"""Dispatching RMSNorm wrapper with a launch counter.

CPU tensors take the plain version (:func:`.ref.rmsnorm_ref`); CUDA
tensors launch the CUDA kernel, and anything else raises. There is no
fallback from the kernel to the plain version.
"""

from __future__ import annotations

import torch

from .ref import rmsnorm_ref
from .rmsnorm import rmsnorm_fwd

__all__ = ["rmsnorm", "launches"]

# Kernel launches through this wrapper (not plain-version calls).
launches = 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    global launches
    if x.is_cuda:
        out = rmsnorm_fwd(x, scale, eps)
        launches += 1
        return out
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")

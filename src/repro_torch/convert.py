"""Parameter bridge: a JAX parameter tree (as numpy) -> the port's tree.

The caller flattens the JAX side with ``jax.tree.map(np.asarray,
params)``; this module needs only numpy. The nested-dict layout, the
stacked leading ``L`` dimension under ``layers`` and every dtype are
kept, so converted parameters drive the port's models with the very
weights the JAX models ran.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from .device import resolve_device

__all__ = ["params_from_jax", "tensor_from_numpy"]


def tensor_from_numpy(arr: np.ndarray,
                      device: Optional[Union[str, torch.device]] = None
                      ) -> torch.Tensor:
    """One leaf, bit-exact, on ``device`` (``None`` = the GPU; pass
    ``"cpu"`` for the CPU). ``torch.from_numpy`` rejects the
    ``ml_dtypes`` bfloat16 that JAX arrays convert to, so bf16 goes
    through a ``uint16`` view of the same bits. The copy also makes the
    read-only buffers ``np.asarray`` gives for JAX arrays writable."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        bits = np.array(arr.view(np.uint16), copy=True)
        t = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(resolve_device(device))


def params_from_jax(tree: Mapping[str, Any],
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same nested dict of tensors on
    ``device`` (``None`` = the GPU; pass ``"cpu"`` for the CPU)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        return tensor_from_numpy(node, dev)

    return walk(tree)

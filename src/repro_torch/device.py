"""Device resolution and the config dtype names -> torch dtypes."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["DTYPES", "torch_dtype", "resolve_device"]

DTYPES = {
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig`` dtype name ("bfloat16", "float32") -> torch dtype."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"known: {sorted(DTYPES)}") from None


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> the GPU. Raises when a GPU is asked for (explicitly
    or by default) and none is present: the CPU is never a silent
    fallback, it must be requested with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev

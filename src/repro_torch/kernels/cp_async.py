"""What the kernels' 16-byte ``cp.async`` copies can read in place.

Flash attention's bf16 kernel and the SSD chunk kernels copy tiles from
device memory to shared memory 16 bytes at a time. Such a copy needs its
source on a 16-byte boundary, so an input must start on one and step
through every dimension but its last (contiguous) one by whole 16-byte
units. An input that cannot be read in place is handed to the kernel as
a copy in fresh memory (:func:`aligned_input`); no wrapper falls back to
a plain version.
"""

from __future__ import annotations

import torch

__all__ = ["CP_ASYNC_BYTES", "cp_async_ready", "aligned_input"]

CP_ASYNC_BYTES = 16


def cp_async_ready(t: torch.Tensor) -> bool:
    """Whether 16-byte copies can read ``t`` in place: its first element
    on a 16-byte boundary and every stride but the last a whole multiple
    of 16 bytes. The stride of a dimension of size 1 is never stepped,
    so it is not looked at."""
    size = t.element_size()
    return t.data_ptr() % CP_ASYNC_BYTES == 0 and all(
        (s * size) % CP_ASYNC_BYTES == 0
        for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n != 1)


def aligned_input(t: torch.Tensor) -> torch.Tensor:
    """``t`` as it is if :func:`cp_async_ready`, else a copy of it in
    fresh memory whose rows start a multiple of 16 bytes apart, seen
    through a view of ``t``'s shape: contiguous where a row is a whole
    number of 16-byte units, else with rows padded to one (SSD rows of
    N = 2 f32 values). ``.contiguous()`` would hand back a contiguous view
    that starts off a 16-byte boundary as it is."""
    if cp_async_ready(t):
        return t
    per = CP_ASYNC_BYTES // t.element_size()
    width = -(-t.shape[-1] // per) * per
    out = torch.empty((*t.shape[:-1], width), dtype=t.dtype, device=t.device)
    out = out[..., :t.shape[-1]]
    out.copy_(t)
    return out

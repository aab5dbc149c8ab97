"""ctypes binding of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``).

The source is compiled by :mod:`repro_torch.kernels.build` the first
time :func:`rmsnorm_fwd` runs; importing this module needs neither
``nvcc`` nor a GPU. See the source's header for what the kernel
replaces, what bounds it and how it is laid out.

At the serving shapes the kernel's device time is ~1.5 µs, so the host
side of a launch is most of a call: between the call and the foreign
function there is one ``torch.empty_like``, three ``data_ptr()``s, the
current stream, checks on shapes and strides that run no tensor op, and
one ``struct.pack`` of the launch's arguments (ctypes converts one bytes
argument far faster than ten ints and pointers).
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import Optional, Sequence

import torch

from ..build import load_library

__all__ = ["rmsnorm_fwd", "row_stride", "MAX_VECTORS", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rmsnorm.cu"
# (x dtype, scale dtype) -> the C entry point's type codes
_DTYPE_CODES = {(x, w): (xc, wc)
                for x, xc in ((torch.float32, 0), (torch.bfloat16, 1), (torch.float16, 2))
                for w, wc in ((torch.float32, 0), (torch.bfloat16, 1))}
MAX_VECTORS = 2048                 # 16-byte vectors per row the kernel holds
_INT32_MAX = 2**31 - 1
# RmsnormArgs of the source: x, w, y, stream, x_rs; rows, D, codes; eps; padding
_ARGS = struct.Struct("<5q4if4x")

_FN = None


def _entry():
    global _FN
    if _FN is None:
        fn = load_library("rmsnorm", [SOURCE]).rmsnorm_fwd
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def row_stride(shape: Sequence[int], stride: Sequence[int]) -> Optional[int]:
    """The element stride between consecutive rows of a tensor of
    ``shape`` and ``stride`` read as (rows, D), or None when its leading
    dimensions do not fold into evenly spaced rows. The last dimension's
    own stride is not looked at."""
    dims = [(n, s) for n, s in zip(shape[:-1], stride[:-1]) if n != 1]
    if not dims:                     # at most one row
        return shape[-1]
    for (_, s), (n1, s1) in zip(dims, dims[1:]):
        if s != s1 * n1:
            return None
    return dims[-1][1]


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on CUDA tensors. x: (..., D) float32, bfloat16
    or float16; scale: (D,) float32 or bfloat16 -> x's shape and dtype."""
    dev = x.get_device()                 # an int: no device object per call
    if not x.is_cuda or scale.get_device() != dev:
        raise ValueError("rmsnorm_fwd needs x and scale on the same CUDA device")
    codes = _DTYPE_CODES.get((x.dtype, scale.dtype))
    if codes is None:
        raise TypeError(f"rmsnorm_fwd: x {x.dtype}, scale {scale.dtype}; x float32, "
                        f"bfloat16 or float16, scale float32 or bfloat16")
    shape = x.shape
    D = shape[-1]
    if scale.shape != (D,) or (D > 1 and scale.stride(0) != 1):
        raise ValueError(f"scale must be contiguous of shape ({D},), "
                         f"got {tuple(scale.shape)}")
    if D * x.element_size() > 16 * MAX_VECTORS:
        raise ValueError(f"rmsnorm_fwd: a row of {D} {x.dtype} is wider than the "
                         f"kernel's {MAX_VECTORS} 16-byte vectors")
    if x.is_contiguous():
        rs = D
        y = torch.empty_like(x)
    else:   # a view: read it in place where its rows are evenly spaced
        rs = row_stride(shape, x.stride()) if D == 1 or x.stride(-1) == 1 else None
        if rs is None:
            x = x.contiguous()
            rs = D
        y = torch.empty(shape, dtype=x.dtype, device=x.device)
    rows = y.numel() // D if D else 0
    if rows == 0:
        return y
    if rows > _INT32_MAX:
        raise ValueError(f"rmsnorm_fwd: {rows} rows exceed the kernel's grid")
    # the raw handle of the current stream, as torch.cuda.current_stream()
    # .cuda_stream gives it, without building a Stream object per call
    stream = torch._C._cuda_getCurrentRawStream(dev)
    err = (_FN or _entry())(_ARGS.pack(x.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                       stream, rs, rows, D, *codes, eps))
    if err != 0:
        raise RuntimeError(f"rmsnorm_fwd launch failed: CUDA error {err}")
    return y

"""ctypes binding of the CUDA SSD intra-chunk kernel (``csrc/ssd_chunk.cu``).

The source is compiled by :mod:`repro_torch.kernels.build` the first
time :func:`ssd_chunk_fwd` runs; importing this module needs neither
``nvcc`` nor a GPU. See the source's header for what the kernel
replaces, what bounds it and how it is laid out.

Inputs are passed through their strides, not copied: ``x`` is usually a
view of the conv output sliced to ``d_inner`` (token stride
``d_inner + 2N``), and in f32 models ``C`` and ``B`` are views of the
same tensor.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from ..build import load_library

__all__ = ["ssd_chunk_fwd", "MAX_Q", "MAX_N", "MAX_P", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"
MAX_Q, MAX_N, MAX_P = 256, 128, 64
_X_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535

_FN = None


def _entry():
    global _FN
    if _FN is None:
        fn = load_library("ssd_chunk", [SOURCE]).ssd_chunk_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def ssd_chunk_fwd(C: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
                  dt: torch.Tensor, da: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel. C, B: (b,nc,Q,N) f32; x: (b,nc,Q,H,P) f32 or
    bf16; dt, da: (b,nc,Q,H) f32 -> y_diag (b,nc,Q,H,P), states
    (b,nc,H,N,P), decays (b,nc,H), all f32. Inputs may be strided views;
    the last dimension of C, B and x must be contiguous."""
    ins = (C, B, x, dt, da)
    if C.device.type != "cuda" or any(t.device != C.device for t in ins):
        raise ValueError("ssd_chunk_fwd needs C, B, x, dt, da on one CUDA device")
    if (x.dtype not in _X_DTYPE_CODES
            or any(t.dtype != torch.float32 for t in (C, B, dt, da))):
        raise TypeError(f"ssd_chunk_fwd: dtypes C {C.dtype}, B {B.dtype}, x {x.dtype}, "
                        f"dt {dt.dtype}, da {da.dtype}; x float32 or bfloat16, "
                        f"the rest float32")
    if C.dim() != 4 or x.dim() != 5 or dt.dim() != 4:
        raise ValueError("C, B must be (b,nc,Q,N), x (b,nc,Q,H,P), dt, da (b,nc,Q,H)")
    b, nc, Q, N = C.shape
    H, P = x.shape[3], x.shape[4]
    if (B.shape != C.shape or tuple(x.shape[:3]) != (b, nc, Q)
            or tuple(dt.shape) != (b, nc, Q, H) or da.shape != dt.shape):
        raise ValueError(f"shape mismatch: C {tuple(C.shape)}, B {tuple(B.shape)}, "
                         f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, da {tuple(da.shape)}")
    if not (0 < Q <= MAX_Q and 0 < N <= MAX_N and 0 < P <= MAX_P):
        raise ValueError(f"ssd_chunk_fwd built for Q <= {MAX_Q}, N <= {MAX_N}, "
                         f"P <= {MAX_P}; got Q={Q}, N={N}, P={P}")
    if b * nc > _MAX_GRID_YZ or H > _MAX_GRID_YZ:
        raise ValueError(f"grid too large: b*nc={b * nc}, H={H} (max {_MAX_GRID_YZ})")
    if any(t.stride(-1) != 1 for t in (C, B, x)):
        raise ValueError("the last dimension of C, B and x must be contiguous")
    dev = C.device
    y = torch.empty((b, nc, Q, H, P), dtype=torch.float32, device=dev)
    states = torch.empty((b, nc, H, N, P), dtype=torch.float32, device=dev)
    decays = torch.empty((b, nc, H), dtype=torch.float32, device=dev)
    strides = (list(C.stride()[:3]) + list(B.stride()[:3]) + list(x.stride()[:4])
               + list(dt.stride()) + list(da.stride()))
    st = (ctypes.c_longlong * 18)(*strides)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry()(C.data_ptr(), B.data_ptr(), x.data_ptr(), dt.data_ptr(),
                   da.data_ptr(), y.data_ptr(), states.data_ptr(), decays.data_ptr(),
                   b, nc, Q, N, H, P, _X_DTYPE_CODES[x.dtype], st, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_fwd launch failed: CUDA error {err}")
    return y, states, decays

"""ctypes binding of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

The source is compiled by :mod:`repro_torch.kernels.build` the first
time :func:`flash_attention_fwd` runs; importing this module needs
neither ``nvcc`` nor a GPU. See the source's header for what the kernel
replaces, what bounds it and how it is laid out.

The library holds two kernels, chosen by dtype: bf16 inputs go to the
tensor-core kernel, f32 inputs to the scalar one. The bf16 kernel copies
tiles with 16-byte ``cp.async``, so each bf16 input must start on a
16-byte boundary and step through batch, sequence and heads by whole
16-byte units; :func:`..cp_async.cp_async_ready` decides that, and an
input that fails it is handed to the kernel as a contiguous copy.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from ..build import load_library
from ..cp_async import aligned_input

__all__ = ["flash_attention_fwd", "HEAD_DIMS", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1

_FN = None


def _entry():
    global _FN
    if _FN is None:
        fn = load_library("flash_attention", [SOURCE]).flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """Launch the kernel. q: (B,S,H,d); k,v: (B,S,K,d) -> (B,S,H,d) in
    q's dtype. Inputs may be strided views; the head dimension must be
    contiguous. bf16 views that the tensor-core kernel cannot read in
    place are copied first (:func:`..cp_async.aligned_input`)."""
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd needs q, k, v on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention_fwd: dtypes {q.dtype}/{k.dtype}/"
                        f"{v.dtype}; supported: float32, bfloat16 (all equal)")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError("q must be (B,S,H,d) and k, v (B,S,K,d)")
    B, S, H, d = q.shape
    K = k.shape[2]
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != d or H % K:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not instantiated; built for {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q, k, v must be contiguous")
    if q.dtype == torch.bfloat16:
        q, k, v = (aligned_input(t) for t in (q, k, v))
    out = torch.empty((B, S, H, d), dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    if max(strides) > _INT32_MAX or max(t.numel() for t in (q, k, out)) > _INT32_MAX:
        raise ValueError("tensor too large for the kernel's 32-bit strides")
    st = (ctypes.c_int * 12)(*strides)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, S, H, K, d, _DTYPE_CODES[q.dtype], st, int(causal),
                   int(window), 1.0 / math.sqrt(d), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error {err}")
    return out

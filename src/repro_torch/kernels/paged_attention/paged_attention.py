"""ctypes binding of the CUDA paged decode-attention kernel
(``csrc/paged_attention.cu``).

The source is compiled by :mod:`repro_torch.kernels.build` the first
time :func:`paged_attention_fwd` runs; importing this module needs
neither ``nvcc`` nor a GPU. See the source's header for what the kernel
computes, what bounds it and how it is laid out.

The library holds a bf16 tensor-core kernel and an f32 scalar one,
chosen by dtype. Both copy rows with 16-byte ``cp.async``: the pool is
read in place and must pass :func:`..cp_async.cp_async_ready` (it is
never copied); q and the chunk's k and v that fail it are handed to the
kernel as aligned copies. The launch's arguments go to the kernel as one
packed struct.
"""

from __future__ import annotations

import ctypes
import math
import struct
from pathlib import Path
from typing import Dict

import torch

from ..build import load_library
from ..cp_async import aligned_input, cp_async_ready

__all__ = ["paged_attention_fwd", "key_splits", "HEAD_DIMS", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
HEAD_DIMS = (16, 64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KEY_TILE = 64                      # keys per tile of the kernel's loop
MAX_SPLITS = 16
# PagedArgs of the source: 24 int64 (addresses, the stream, strides), 10
# int32 (B, C, H, K, D, nb, bs, window, nsplit, dtype), the f32 scale
_ARGS = struct.Struct("<24q10if4x")

_FN = None
_SMS: Dict[int, int] = {}


def _entry():
    global _FN
    if _FN is None:
        fn = load_library("paged_attention", [SOURCE]).paged_attention_fwd
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def key_splits(blocks: int, max_tiles: int, sms: int) -> int:
    """Splits over keys (flash-decoding) for a grid of ``blocks`` (slot,
    KV head) blocks on a card of ``sms`` SMs: 1 from two blocks per SM
    up, else enough to reach two per SM, at most one per key tile and
    at most MAX_SPLITS."""
    if blocks >= 2 * sms:
        return 1
    return max(1, min(-(-2 * sms // blocks), max_tiles, MAX_SPLITS))


def _int32(t: torch.Tensor) -> torch.Tensor:
    return t if t.dtype == torch.int32 and t.is_contiguous() else (
        t.to(torch.int32).contiguous())


def paged_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pool_k: torch.Tensor, pool_v: torch.Tensor,
                        block_table: torch.Tensor, pos: torch.Tensor, adv: torch.Tensor,
                        *, window: int = 0) -> torch.Tensor:
    """Launch the kernel. q: (B,C,H,d); k, v: (B,C,K,d); pool_k, pool_v:
    (NB,bs,K,d); block_table: (B,nb); pos, adv: (B,) -> (B,C,H,d) in q's
    dtype, rows j >= adv[b] zeros. Shapes, dtypes and the head dim are
    checked before the device."""
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in (k, v, pool_k, pool_v)):
        raise TypeError(f"paged_attention_fwd: dtypes {q.dtype}/{k.dtype}/{v.dtype}/"
                        f"{pool_k.dtype}/{pool_v.dtype}; supported: float32, bfloat16 "
                        "(all equal)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or pool_k.dim() != 4 \
            or pool_k.shape != pool_v.shape:
        raise ValueError("q must be (B,C,H,d), k and v (B,C,K,d), the pools (NB,bs,K,d)")
    B, C, H, d = q.shape
    K = k.shape[2]
    if tuple(k.shape) != (B, C, K, d) or pool_k.shape[2:] != (K, d) or H % K \
            or block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(pos.shape) != (B,) or tuple(adv.shape) != (B,):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, pool "
                         f"{tuple(pool_k.shape)}, table {tuple(block_table.shape)}, pos "
                         f"{tuple(pos.shape)}, adv {tuple(adv.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not built; built for {HEAD_DIMS}")
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (k, v, pool_k, pool_v, block_table, pos, adv)):
        raise ValueError("paged_attention_fwd needs every input on one CUDA device")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dimension of q, k, v must be contiguous")
    if pool_k.stride() != pool_v.stride() or not (cp_async_ready(pool_k)
                                                  and cp_async_ready(pool_v)):
        raise ValueError("the pools must share strides and be readable by 16-byte "
                         "copies in place (cp_async_ready)")
    q, k, v = (aligned_input(t) for t in (q, k, v))
    table, pos, adv = _int32(block_table), _int32(pos), _int32(adv)
    nb, bs = table.shape[1], pool_k.shape[1]
    out = torch.empty((B, C, H, d), dtype=q.dtype, device=dev)
    nsplit, part = 1, None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if q.dtype == torch.bfloat16:
        sms = _SMS.get(index)
        if sms is None:
            sms = _SMS[index] = torch.cuda.get_device_properties(index).multi_processor_count
        max_tiles = -(-nb * bs // KEY_TILE) + -(-C // KEY_TILE)
        nsplit = key_splits(B * K, max_tiles, sms)
        if nsplit > 1:
            part = torch.empty(B * C * H * nsplit * (d + 2), dtype=torch.float32, device=dev)
    # the raw handle of the current stream, without a Stream object per call
    stream = torch._C._cuda_getCurrentRawStream(index)
    err = (_FN or _entry())(_ARGS.pack(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
        table.data_ptr(), pos.data_ptr(), adv.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), stream,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *pool_k.stride()[:3],
        table.stride(0), B, C, H, K, d, nb, bs, int(window), nsplit,
        _DTYPE_CODES[q.dtype], 1.0 / math.sqrt(d)))
    if err != 0:
        raise RuntimeError(f"paged_attention_fwd launch failed: CUDA error {err}")
    return out

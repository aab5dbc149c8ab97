"""ctypes binding of the CUDA SSD intra-chunk kernels (``csrc/ssd_chunk.cu``).

The source is compiled by :mod:`repro_torch.kernels.build` the first
time :func:`ssd_chunk_fwd` runs; importing this module needs neither
``nvcc`` nor a GPU. See the source's header for what the kernels
replace, what bounds them and how they are laid out.

One call launches two kernels: ``ssd_cb_kernel`` writes C·Bᵀ once per
chunk, and each head's running decay sums, into f32 scratch
(:func:`scratch_shapes`) that this module allocates, and
``ssd_chunk_kernel`` reads them for every head.

Inputs are passed through their strides, not copied: ``x`` is usually a
view of the conv output sliced to ``d_inner`` (token stride
``d_inner + 2N``), and in f32 models ``C`` and ``B`` are views of the
same tensor. The kernels read C, B and x with 16-byte ``cp.async``; an
input they cannot read in place (:func:`..cp_async.cp_async_ready`) is
handed over as a copy (:func:`..cp_async.aligned_input`).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Tuple

import torch

from ..build import load_library
from ..cp_async import aligned_input

__all__ = ["ssd_chunk_fwd", "scratch_shapes", "check_inputs", "kernel_attrs",
           "KERNELS", "MAX_Q", "MAX_N", "MAX_P", "SOURCE"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_chunk.cu"
MAX_Q, MAX_N, MAX_P = 256, 128, 64
_X_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
# the kernels of the library, in the order ssd_kernel_attrs reports them
KERNELS = ("ssd_cb_kernel", "ssd_chunk_kernel<float>", "ssd_chunk_kernel<bf16>")
_TILE = 64

_FN = None


def _library():
    return load_library("ssd_chunk", [SOURCE])


def kernel_attrs() -> Dict[str, Dict[str, int]]:
    """Per kernel of :data:`KERNELS`, what the CUDA runtime reports of the
    loaded library: ``registers`` per thread and ``local_bytes``, the
    local memory per thread that register spills and stack take. Builds
    the library if it is not built yet; needs a GPU."""
    out = (ctypes.c_int * 6)()
    err = _library().ssd_kernel_attrs(out)
    if err != 0:
        raise RuntimeError(f"ssd_kernel_attrs failed: CUDA error {err}")
    return {k: {"registers": out[2 * i], "local_bytes": out[2 * i + 1]}
            for i, k in enumerate(KERNELS)}


def _entry():
    global _FN
    if _FN is None:
        fn = _library().ssd_chunk_fwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def scratch_shapes(b: int, nc: int, Q: int, H: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the two f32 scratch tensors, Qp = Q rounded up to the
    64-row tile: ``cb``, C·Bᵀ as one (Qp, Qp) matrix per (batch, chunk),
    of which only the lower triangle of tiles is written; ``aux``, per
    (batch, chunk, head) the running sum of da, dt and
    dt·exp(total − cum) over the chunk's rows."""
    qp = -(-Q // _TILE) * _TILE
    return {"cb": (b * nc, qp, qp), "aux": (b * nc, H, 3, qp)}


def check_inputs(C: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
                 dt: torch.Tensor, da: torch.Tensor) -> Tuple[int, ...]:
    """(b, nc, Q, N, H, P) of inputs the kernels take; raises TypeError or
    ValueError, before anything is built, on dtypes, shapes or layouts
    they do not take."""
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
    if not (0 < Q <= MAX_Q and 0 < N <= MAX_N and 0 < P <= MAX_P and H > 0):
        raise ValueError(f"ssd_chunk_fwd built for Q <= {MAX_Q}, N <= {MAX_N}, "
                         f"P <= {MAX_P}, H > 0; got Q={Q}, N={N}, P={P}, H={H}")
    if b * nc > _MAX_GRID_YZ:
        raise ValueError(f"grid too large: b*nc={b * nc} (max {_MAX_GRID_YZ})")
    if any(t.stride(-1) != 1 for t in (C, B, x)):
        raise ValueError("the last dimension of C, B and x must be contiguous")
    return b, nc, Q, N, H, P


def ssd_chunk_fwd(C: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
                  dt: torch.Tensor, da: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernels. C, B: (b,nc,Q,N) f32; x: (b,nc,Q,H,P) f32 or
    bf16; dt, da: (b,nc,Q,H) f32 -> y_diag (b,nc,Q,H,P), states
    (b,nc,H,N,P), decays (b,nc,H), all f32. Inputs may be strided views;
    the last dimension of C, B and x must be contiguous, and those the
    kernels cannot read in place are copied first (:func:`..cp_async.aligned_input`)."""
    if C.device.type != "cuda" or any(t.device != C.device for t in (B, x, dt, da)):
        raise ValueError("ssd_chunk_fwd needs C, B, x, dt, da on one CUDA device")
    b, nc, Q, N, H, P = check_inputs(C, B, x, dt, da)
    C, B, x = (aligned_input(t) for t in (C, B, x))
    dev = C.device
    shapes = scratch_shapes(b, nc, Q, H)
    sizes = [math.prod(v) for v in shapes.values()]
    cb, aux = torch.empty(sum(sizes), dtype=torch.float32, device=dev).split(sizes)
    y = torch.empty((b, nc, Q, H, P), dtype=torch.float32, device=dev)
    states = torch.empty((b, nc, H, N, P), dtype=torch.float32, device=dev)
    decays = torch.empty((b, nc, H), dtype=torch.float32, device=dev)
    strides = (list(C.stride()[:3]) + list(B.stride()[:3]) + list(x.stride()[:4])
               + list(dt.stride()) + list(da.stride()))
    st = (ctypes.c_longlong * 18)(*strides)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _entry()(C.data_ptr(), B.data_ptr(), x.data_ptr(), dt.data_ptr(),
                   da.data_ptr(), cb.data_ptr(), aux.data_ptr(), y.data_ptr(),
                   states.data_ptr(), decays.data_ptr(), b, nc, Q, N, H, P,
                   _X_DTYPE_CODES[x.dtype], st, stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk_fwd launch failed: CUDA error {err}")
    return y, states, decays

"""Fused RMSNorm row kernel for Hopper, in Triton.

Replaces ``_rmsnorm_kernel`` / ``rmsnorm_fwd`` of the JAX package
(``src/repro/kernels/rmsnorm/rmsnorm.py``), which tiled rows into
``(256, D)`` VMEM blocks on the TPU.

What bounds it on the card: memory. Each row is read once and written
once with ~4 flops per element, far below the ~295 flops per byte an
H100 needs before compute matters; the floor is
``(2 * rows * D * itemsize + D * scale_itemsize) / 3.35 TB/s``.

What the design does about it: one program per row holds the whole row
in registers (``BLOCK_D = next_power_of_2(D)`` lanes, masked), so the
mean-square reduction and the scale multiply happen on the loaded
values and the row touches device memory exactly twice — no second
read for the scale pass. Sums and the scale multiply run in f32; the
store rounds once to the input dtype. No tensor cores are involved, so
Triton's masked block expresses the kernel fully.

``triton`` is imported only inside :func:`rmsnorm_fwd`: importing this
module needs neither triton nor a GPU.
"""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_fwd"]

_KERNEL = None


def _kernel():
    """Define (once) and return the ``@triton.jit`` kernel."""
    global _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language as tl

        @triton.jit
        def _rmsnorm_kernel(x_ptr, w_ptr, y_ptr, stride_x, stride_y, D, eps,
                            BLOCK_D: tl.constexpr):
            row = tl.program_id(0)
            cols = tl.arange(0, BLOCK_D)
            mask = cols < D
            x = tl.load(x_ptr + row * stride_x + cols, mask=mask,
                        other=0.0).to(tl.float32)
            var = tl.sum(x * x, axis=0) / D
            rstd = 1.0 / tl.sqrt(var + eps)
            w = tl.load(w_ptr + cols, mask=mask, other=0.0).to(tl.float32)
            y = x * rstd * w
            tl.store(y_ptr + row * stride_y + cols,
                     y.to(y_ptr.dtype.element_ty), mask=mask)

        _KERNEL = (_rmsnorm_kernel, triton.next_power_of_2)
    return _KERNEL


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Launch the kernel on CUDA tensors. x: (..., D); scale: (D,)."""
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("rmsnorm_fwd needs x and scale on the same CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rmsnorm_fwd: unsupported dtype {x.dtype}")
    D = x.shape[-1]
    if scale.shape != (D,) or not scale.is_contiguous():
        raise ValueError(f"scale must be contiguous of shape ({D},), "
                         f"got {tuple(scale.shape)}")
    x2 = x.reshape(-1, D)
    if x2.stride(-1) != 1:
        x2 = x2.contiguous()
    rows = x2.shape[0]
    y = torch.empty((rows, D), dtype=x.dtype, device=x.device)
    if rows == 0:
        return y.reshape(x.shape)
    kernel, next_pow2 = _kernel()
    block_d = next_pow2(D)
    num_warps = min(max(block_d // 256, 1), 8)
    kernel[(rows,)](x2, scale, y, x2.stride(0), y.stride(0), D, float(eps),
                    BLOCK_D=block_d, num_warps=num_warps)
    return y.reshape(x.shape)

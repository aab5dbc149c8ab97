"""Plain PyTorch SSD intra-chunk block: the CUDA kernel's reference and its CPU path."""

from __future__ import annotations

from typing import Tuple

import torch


def _segsum(t: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular segment sums:
    out[i, j] = sum(t[j+1..i]) for i >= j, -inf above the diagonal."""
    Q = t.shape[-1]
    c = torch.cumsum(t, dim=-1)
    out = c[..., :, None] - c[..., None, :]
    lower = torch.ones((Q, Q), dtype=torch.bool, device=t.device).tril()
    return out.masked_fill(~lower, -torch.inf)


def ssd_chunk_ref(C: torch.Tensor, B: torch.Tensor, x: torch.Tensor,
                  dt: torch.Tensor, da: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """C, B: (b,nc,Q,N); x: (b,nc,Q,H,P); dt, da: (b,nc,Q,H).

    Returns y_diag (b,nc,Q,H,P), states (b,nc,H,N,P) and decays
    (b,nc,H), all f32 — the contract of the kernel:

      y_diag[i]  = sum_{j<=i} (C_i . B_j) * exp(cum_i - cum_j) * x_j * dt_j
      state      = sum_j B_j^T (x_j * dt_j * exp(total - cum_j))
      decay      = exp(total)

    with ``cum`` the running sum of ``da`` over the chunk and ``total``
    its last entry.
    """
    Cf, Bf = C.float(), B.float()
    xdt = x.float() * dt.float()[..., None]
    da = da.float()

    L = torch.exp(_segsum(da.permute(0, 1, 3, 2)))                # (b,nc,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)[:, :, None] * L
    y = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)

    cum = torch.cumsum(da, dim=2)                                 # (b,nc,Q,H)
    total = cum[:, :, -1]                                         # (b,nc,H)
    decay_to_end = torch.exp(total[:, :, None] - cum)             # (b,nc,Q,H)
    states = torch.einsum("bcqn,bcqh,bcqhp->bchnp", Bf, decay_to_end, xdt)
    return y, states, torch.exp(total)

"""Plain PyTorch attention: the flash kernel's reference and its CPU path."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B,S,H,d); k,v: (B,S,K,d) -> (B,S,H,d). f32 softmax."""
    B, S, H, d = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, d)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) / math.sqrt(d)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    s = torch.where(mask[None, None, None], s, torch.full((), -1e30, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, S, H, d).to(q.dtype)

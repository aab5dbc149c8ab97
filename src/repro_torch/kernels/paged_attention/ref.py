"""Plain PyTorch paged decode attention: the kernel's reference and its
CPU path (the JAX package's ``attention_decode_paged`` arithmetic)."""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), NEG_INF, dtype=like.dtype, device=like.device)


def paged_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        pool_k: torch.Tensor, pool_v: torch.Tensor,
                        block_table: torch.Tensor, pos: torch.Tensor, adv: torch.Tensor,
                        *, window: int = 0) -> torch.Tensor:
    """q: (B,C,H,hd) after RoPE; k, v: (B,C,K,hd) the chunk's own keys and
    values; pool_k, pool_v: (NB,bs,K,hd) the block pool; block_table:
    (B,nb); pos: (B,) tokens resident per slot; adv: (B,) real tokens in
    the chunk -> (B,C,H,hd) in q's dtype.

    Every slot's whole table is gathered logical-contiguous; the queries
    attend to the resident keys (``kpos < pos`` and the window) plus the
    chunk's keys under a causal mask (``j < adv``), in one f32 softmax
    whose probabilities are cast to q's dtype before the PV products."""
    B, C, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    cdt = q.dtype
    nb, bs = block_table.shape[1], pool_k.shape[1]
    S = nb * bs
    scale = 1.0 / math.sqrt(hd)
    dev = q.device

    jj = torch.arange(C, dtype=pos.dtype, device=dev)
    qpos = pos[:, None] + jj[None, :]                                 # (B,C)
    # resident keys, gathered logical-contiguous through the block table
    ck = pool_k[block_table.long()].reshape(B, S, K, hd).to(cdt)
    cv = pool_v[block_table.long()].reshape(B, S, K, hd).to(cdt)
    kpos = torch.arange(S, dtype=pos.dtype, device=dev)
    mask_res = kpos[None, None, :] < pos[:, None, None]               # (B,1,S)
    mask_res = mask_res.expand(B, C, S)
    mask_chunk = (jj[None, :] <= jj[:, None])[None]                   # causal (1,C,C)
    mask_chunk = mask_chunk & (jj[None, None, :] < adv[:, None, None])
    if window > 0:
        mask_res = mask_res & (kpos[None, None, :] > qpos[:, :, None] - window)
        mask_chunk = mask_chunk & (qpos[:, None, :] > qpos[:, :, None] - window)

    qg = q.reshape(B, C, K, G, hd)
    s_res = torch.einsum("bqkgh,bskh->bkgqs", qg, ck).float() * scale
    s_chk = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    s_res = torch.where(mask_res[:, None, None], s_res, _neg_inf(s_res))
    s_chk = torch.where(mask_chunk[:, None, None], s_chk, _neg_inf(s_chk))
    scores = torch.cat([s_res, s_chk], dim=-1)                        # (B,K,G,C,S+C)
    w = torch.softmax(scores, dim=-1).to(cdt)
    out = (torch.einsum("bkgqs,bskh->bqkgh", w[..., :S], cv)
           + torch.einsum("bkgqs,bskh->bqkgh", w[..., S:], v))
    return out.reshape(B, C, H, hd)

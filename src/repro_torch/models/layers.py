"""Model layers, PyTorch. One param-builder + one apply per layer kind.

The dense, moe, ssm and hybrid subset of the JAX package's
``models/layers.py``: RMSNorm, RoPE (half-split layout), GQA attention
with its dense, blockwise and kernel paths, the dense and paged decode
steps, the SwiGLU / GeGLU / GELU FFN, the top-k capacity-dropped MoE
block, and the Mamba-2 SSD block (chunked prefill, one-token and
chunked decode). Numerics follow the reference
point for point: f32 softmax,
the probabilities cast to the compute dtype before the PV product, and
``-1e30`` (not ``-inf``) for masked scores, so a fully masked row gets a
uniform softmax rather than NaN.

The sharding constraints of the JAX version only place tensors on a
mesh; on one device they have no counterpart and are dropped.

RMSNorm, the flash attention path and the SSD intra-chunk block go
through the hand-written kernels' wrappers, which launch the kernel for
CUDA tensors and take the plain version for CPU tensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention.ops import flash_attention
from ..kernels.rmsnorm.ops import rmsnorm as rmsnorm_op
from ..kernels.ssd_scan.ops import ssd_chunk
from .config import ModelConfig
from .modules import Builder, he_normal, normal_init, ones_init, zeros_init

BLOCKWISE_THRESHOLD = 8192
Q_BLOCK = 1024
KV_BLOCK = 1024
NEG_INF = -1e30

Params = Dict[str, Any]


def _neg_inf(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), NEG_INF, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def build_rmsnorm(b: Builder, name: str, dim: int) -> Params:
    with b.scope(name):
        return {"scale": b.param("scale", (dim,), ("norm",), ones_init)}


def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return rmsnorm_op(x, p["scale"], eps)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_table(positions: torch.Tensor, head_dim: int, theta: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for given absolute positions: (..., head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, ..., head_dim); cos/sin: (B?, S, head_dim//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    while cos.dim() < x.dim():
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    xf1, xf2 = x1.float(), x2.float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA, causal, optional sliding window)
# ---------------------------------------------------------------------------


def build_attention(b: Builder, cfg: ModelConfig) -> Params:
    hd = cfg.resolved_head_dim
    with b.scope("attn"):
        p = {
            "wq": b.param("wq", (cfg.d_model, cfg.num_heads, hd),
                          ("embed", "heads_tp", None), he_normal, fan_in=cfg.d_model),
            "wk": b.param("wk", (cfg.d_model, cfg.num_kv_heads, hd),
                          ("embed", "kv_tp", None), he_normal, fan_in=cfg.d_model),
            "wv": b.param("wv", (cfg.d_model, cfg.num_kv_heads, hd),
                          ("embed", "kv_tp", None), he_normal, fan_in=cfg.d_model),
            "wo": b.param("wo", (cfg.num_heads, hd, cfg.d_model),
                          ("heads_tp", None, "embed"), he_normal,
                          fan_in=cfg.num_heads * hd),
        }
        if cfg.qkv_bias:
            p["bq"] = b.param("bq", (cfg.num_heads, hd), ("heads_tp", None), zeros_init)
            p["bk"] = b.param("bk", (cfg.num_kv_heads, hd), ("kv_tp", None), zeros_init)
            p["bv"] = b.param("bv", (cfg.num_kv_heads, hd), ("kv_tp", None), zeros_init)
        return p


def _project_qkv(cfg: ModelConfig, p: Params, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The q/k/v projections (+ qkv bias), before RoPE."""
    cdt = cfg.compute_torch_dtype()
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    return q, k, v


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor, positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q, k, v = _project_qkv(cfg, p, x)
    cos, sin = rope_table(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, window: int) -> torch.Tensor:
    """(.., Sq, Sk) bool mask: causal, optionally sliding-window."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m = m & (k_pos[None, :] > (q_pos[:, None] - window))
    return m


def _attend_dense(cfg: ModelConfig, q, k, v, q_pos, k_pos) -> torch.Tensor:
    """q: (B,Sq,H,hd) k,v: (B,Sk,K,hd) -> (B,Sq,H,hd). f32 softmax."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    mask = _mask(q_pos, k_pos, cfg.sliding_window)
    scores = torch.where(mask[None, None, None], scores, _neg_inf(scores))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v)
    return out.reshape(B, Sq, H, hd)


def _attend_blockwise(cfg: ModelConfig, q, k, v, q_pos, k_pos) -> torch.Tensor:
    """Online-softmax attention, O(Q_BLOCK*KV_BLOCK) score memory."""
    B, S, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    nq = -(-S // Q_BLOCK)
    nk = -(-S // KV_BLOCK)
    pad_q = nq * Q_BLOCK - S
    pad_k = nk * KV_BLOCK - S
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    qpos = F.pad(q_pos, (0, pad_q), value=-1)        # padded q: masked out
    kpos = F.pad(k_pos, (0, pad_k), value=2**30)     # padded k: future
    qb = qp.reshape(B, nq, Q_BLOCK, K, G, hd).permute(1, 0, 3, 4, 2, 5)
    kb = kp.reshape(B, nk, KV_BLOCK, K, hd).permute(1, 0, 3, 2, 4)
    vb = vp.reshape(B, nk, KV_BLOCK, K, hd).permute(1, 0, 3, 2, 4)
    qposb = qpos.reshape(nq, Q_BLOCK)
    kposb = kpos.reshape(nk, KV_BLOCK)

    outs = []
    for i in range(nq):
        qi, qpos_i = qb[i], qposb[i]                 # (B,K,G,Q,hd), (Q,)
        acc = torch.zeros((B, K, G, Q_BLOCK, hd), dtype=torch.float32, device=q.device)
        m = torch.full((B, K, G, Q_BLOCK), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, K, G, Q_BLOCK), dtype=torch.float32, device=q.device)
        for j in range(nk):
            kj, vj = kb[j], vb[j]
            s = torch.einsum("bkgqh,bksh->bkgqs", qi, kj).float() * scale
            msk = _mask(qpos_i, kposb[j], cfg.sliding_window)
            s = torch.where(msk[None, None, None], s, _neg_inf(s))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bksh->bkgqh", p.to(qi.dtype), vj).float()
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
    out = torch.stack(outs)                          # (nq,B,K,G,Q,hd)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, nq * Q_BLOCK, H, hd)
    return out[:, :S]


def attention_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    positions: torch.Tensor,
                    attention_impl: str = "auto") -> torch.Tensor:
    """Training/prefill self-attention. x: (B,S,D) -> (B,S,D)."""
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x, positions[None, :] if positions.dim() == 1 else positions)
    pos = positions if positions.dim() == 1 else positions[0]
    if attention_impl == "kernel":
        out = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
    elif attention_impl == "dense" or (attention_impl == "auto"
                                       and S <= BLOCKWISE_THRESHOLD):
        out = _attend_dense(cfg, q, k, v, pos, pos)
    elif attention_impl == "auto":
        out = _attend_blockwise(cfg, q, k, v, pos, pos)
    else:
        raise ValueError(f"unknown attention_impl {attention_impl!r}")
    cdt = cfg.compute_torch_dtype()
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))


def attention_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], pos: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x: (B,1,D); cache k/v: (B,Scache,K,hd).

    ``pos`` is a scalar (whole-batch clock) or a per-slot vector (B,).
    Sliding-window configs keep a ring buffer of size min(window,
    S_max); keys carry their RoPE at write time so slot order is
    irrelevant. The cache is written in place (the JAX version returns
    an updated copy) and returned.
    """
    B = x.shape[0]
    cdt = cfg.compute_torch_dtype()
    Scache = cache["k"].shape[1]
    pos = torch.broadcast_to(pos, (B,))
    q, k, v = _project_qkv(cfg, p, x)
    cos, sin = rope_table(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    slot = pos % Scache if cfg.sliding_window > 0 else pos
    rows = torch.arange(B, device=x.device)
    ck, cv = cache["k"], cache["v"]
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    qg = q.reshape(B, 1, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, ck.to(cdt)).float() / math.sqrt(hd)
    idx = torch.arange(Scache, device=x.device)
    if cfg.sliding_window > 0:
        valid = idx[None, :] < torch.clamp(pos + 1, max=Scache)[:, None]
    else:
        valid = idx[None, :] <= pos[:, None]
    scores = torch.where(valid[:, None, None, None, :], scores, _neg_inf(scores))
    w = torch.softmax(scores, dim=-1).to(cdt)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, cv.to(cdt)).reshape(B, 1, H, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))
    return y, {"k": ck, "v": cv}


def attention_decode_paged(cfg: ModelConfig, p: Params, x: torch.Tensor,
                           kv: Dict[str, torch.Tensor], block_table: torch.Tensor,
                           pos: torch.Tensor, adv: torch.Tensor
                           ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Chunked decode against a paged (block) KV cache.

    x: (B,C,D) post-norm chunk; kv k/v: (NB, bs, K, hd) — the physical
    block pool shared by every slot (block 0 is the reserved always-zero
    sentinel); block_table: (B, nb) slot-logical block -> physical
    block; pos: (B,) tokens already resident per slot; adv: (B,) real
    tokens in this chunk per slot (0 = slot inactive).

    Queries attend to the pre-chunk resident keys (gathered through the
    block table, masked to ``kpos < pos`` and the window) plus the
    in-chunk keys under a causal mask, in one softmax; the chunk's K/V
    are then written into the pool at positions [pos, pos+adv). The pool
    is written in place, where the JAX version's is donated.
    """
    B, C, _ = x.shape
    cdt = cfg.compute_torch_dtype()
    NB, bs = kv["k"].shape[0], kv["k"].shape[1]
    nb = block_table.shape[1]
    S = nb * bs
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    dev = x.device

    jj = torch.arange(C, dtype=pos.dtype, device=dev)
    qpos = pos[:, None] + jj[None, :]                                 # (B,C)
    q, k, v = _project_qkv(cfg, p, x)
    cos, sin = rope_table(qpos, hd, cfg.rope_theta)                   # (B,C,half)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    # resident keys, gathered logical-contiguous through the block table
    ck = kv["k"][block_table.long()].reshape(B, S, K, hd).to(cdt)
    cv = kv["v"][block_table.long()].reshape(B, S, K, hd).to(cdt)
    kpos = torch.arange(S, dtype=pos.dtype, device=dev)
    mask_res = kpos[None, None, :] < pos[:, None, None]               # (B,1,S)
    mask_res = mask_res.expand(B, C, S)
    mask_chunk = (jj[None, :] <= jj[:, None])[None]                   # causal (1,C,C)
    mask_chunk = mask_chunk & (jj[None, None, :] < adv[:, None, None])
    if cfg.sliding_window > 0:
        w_ = cfg.sliding_window
        mask_res = mask_res & (kpos[None, None, :] > qpos[:, :, None] - w_)
        mask_chunk = mask_chunk & (qpos[:, None, :] > qpos[:, :, None] - w_)

    qg = q.reshape(B, C, K, G, hd)
    s_res = torch.einsum("bqkgh,bskh->bkgqs", qg, ck).float() * scale
    s_chk = torch.einsum("bqkgh,bskh->bkgqs", qg, k).float() * scale
    s_res = torch.where(mask_res[:, None, None], s_res, _neg_inf(s_res))
    s_chk = torch.where(mask_chunk[:, None, None], s_chk, _neg_inf(s_chk))
    scores = torch.cat([s_res, s_chk], dim=-1)                        # (B,K,G,C,S+C)
    w = torch.softmax(scores, dim=-1).to(cdt)
    out = (torch.einsum("bkgqs,bskh->bqkgh", w[..., :S], cv)
           + torch.einsum("bkgqs,bskh->bqkgh", w[..., S:], v))
    out = out.reshape(B, C, H, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))

    # Write the chunk's K/V into the pool. JAX drops padded rows
    # (j >= adv) and sentinel targets with an out-of-range index under
    # mode="drop"; index_put_ has no drop mode, so those rows are sent
    # to the sentinel block 0 with value zero instead — the sentinel
    # stays all-zero, and no host sync is needed to filter indices.
    lb = torch.clamp(torch.div(qpos, bs, rounding_mode="floor"), 0, nb - 1)
    blk = torch.gather(block_table.long(), 1, lb.long())              # (B,C)
    writable = (jj[None, :] < adv[:, None]) & (blk > 0)
    blk = torch.where(writable, blk, torch.zeros_like(blk))
    off = qpos % bs
    keep = writable[..., None, None]
    for name, new in (("k", k), ("v", v)):
        buf = kv[name]
        vals = torch.where(keep, new.to(buf.dtype),
                           torch.zeros((), dtype=buf.dtype, device=dev))
        buf.index_put_((blk, off.long()), vals)
    return y, kv


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: torch.device, dtype: Optional[torch.dtype] = None
                  ) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.compute_torch_dtype()
    size = min(max_len, cfg.sliding_window) if cfg.sliding_window > 0 else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# Dense FFN (SwiGLU / GeGLU / GELU)
# ---------------------------------------------------------------------------


def build_mlp(b: Builder, cfg: ModelConfig, name: str = "mlp",
              d_ff: Optional[int] = None) -> Params:
    d_ff = d_ff or cfg.d_ff
    with b.scope(name):
        p = {
            "w_up": b.param("w_up", (cfg.d_model, d_ff), ("embed", "ffn_tp"),
                            he_normal, fan_in=cfg.d_model),
            "w_down": b.param("w_down", (d_ff, cfg.d_model), ("ffn_tp", "embed"),
                              he_normal, fan_in=d_ff),
        }
        if cfg.act in ("swiglu", "geglu"):
            p["w_gate"] = b.param("w_gate", (cfg.d_model, d_ff),
                                  ("embed", "ffn_tp"), he_normal, fan_in=cfg.d_model)
        return p


def mlp_apply(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    cdt = cfg.compute_torch_dtype()
    up = torch.einsum("bsd,df->bsf", x, p["w_up"].to(cdt))
    if cfg.act == "swiglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(cdt))
        h = F.silu(g) * up
    elif cfg.act == "geglu":
        g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(cdt))
        h = F.gelu(g, approximate="tanh") * up       # jax.nn.gelu's default
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(cdt))


# ---------------------------------------------------------------------------
# MoE (top-k routing, capacity-dropped index dispatch)
# ---------------------------------------------------------------------------


def build_moe(b: Builder, cfg: ModelConfig) -> Params:
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    with b.scope("moe"):
        p = {
            "router": b.param("router", (D, E), ("embed", "experts"),
                              normal_init(0.02), dtype=torch.float32),
            "w_up": b.param("w_up", (E, D, F_),
                            ("experts", "expert_embed", "expert_ffn"),
                            he_normal, fan_in=D),
            "w_gate": b.param("w_gate", (E, D, F_),
                              ("experts", "expert_embed", "expert_ffn"),
                              he_normal, fan_in=D),
            "w_down": b.param("w_down", (E, F_, D),
                              ("experts", "expert_ffn", "expert_embed"),
                              he_normal, fan_in=F_),
        }
        if cfg.dense_residual:
            p["dense"] = build_mlp(b, cfg, "dense_residual", cfg.d_ff)
        return p


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for T routed rows: ceil(T*k*cf/E) rounded up to
    a multiple of 128, at least 128 (from the shape, on the host)."""
    cap = int(math.ceil(T * cfg.top_k * cfg.capacity_factor / cfg.num_experts
                        / 128.0) * 128)
    return max(cap, 128)


class _Routing(NamedTuple):
    logits: torch.Tensor     # (T,E) f32
    probs: torch.Tensor      # (T,E) f32
    ids: torch.Tensor        # (T,k) chosen experts, best first
    weights: torch.Tensor    # (T,k) f32, renormalised over the k choices
    counts: torch.Tensor     # (E,) choices per expert, drops included
    slot: torch.Tensor       # (T*k,) place of each (token, choice) in its expert
    keep: torch.Tensor       # (T*k,) bool: slot < cap
    cap: int


def _route(cfg: ModelConfig, p: Params, xt: torch.Tensor) -> _Routing:
    """The router of :func:`moe_apply` for rows ``xt`` (T,D).

    Top-k is a stable descending sort cut to k: on equal probabilities
    the lower expert comes first, as ``lax.top_k`` orders them
    (``torch.topk`` orders such ties the other way, which would swap a
    token's choices in the capacity order). A choice's slot is the
    number of earlier choices of its expert over the flattened (token,
    choice) order; a choice at ``slot >= cap`` is dropped."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.top_k
    logits = xt.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    cap = moe_capacity(cfg, T)
    flat = ids.reshape(-1)
    onehot = (flat[:, None] == torch.arange(E, device=xt.device)).long()
    slots = torch.cumsum(onehot, dim=0) - onehot               # exclusive
    slot = torch.gather(slots, 1, flat[:, None])[:, 0]
    return _Routing(logits, probs, ids, weights, onehot.sum(0), slot, slot < cap, cap)


def moe_apply(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,D) -> (y, aux losses). Capacity-dropped top-k dispatch.

    No atomics and no host syncs: every kept choice has its own (expert,
    slot), so a plain ``index_put_`` into zeros gives the bits of JAX's
    ``.at[].add``; dropped choices go to one spill row past the E*cap
    expert rows, which is never read. The k choices of a token are
    summed in choice order."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    cdt = cfg.compute_torch_dtype()
    T = B * S
    xt = x.reshape(T, D)
    r = _route(cfg, p, xt)
    cap = r.cap

    # aux losses (Switch-style load balance + router z-loss), f32
    me = r.probs.mean(dim=0)                                     # (E,)
    ce = r.counts.float() / (T * k)
    lb_loss = E * torch.sum(me * ce) * cfg.load_balance_loss
    z_loss = torch.mean(torch.logsumexp(r.logits, dim=-1) ** 2) * cfg.router_z_loss

    flat = r.ids.reshape(-1)                                     # (T*k,)
    tok = torch.arange(T, device=x.device).repeat_interleave(k)
    spill = E * cap
    dest = torch.where(r.keep, flat * cap + r.slot, torch.full_like(flat, spill))
    buf = torch.zeros((spill + 1, D), dtype=cdt, device=x.device)
    buf.index_put_((dest,), xt[tok].to(cdt))
    eb = buf[:spill].view(E, cap, D)

    up = torch.einsum("ecd,edf->ecf", eb, p["w_up"].to(cdt))
    gate = torch.einsum("ecd,edf->ecf", eb, p["w_gate"].to(cdt))
    if cfg.act == "geglu":
        act = F.gelu(gate, approximate="tanh") * up   # jax.nn.gelu's default
    else:
        act = F.silu(gate) * up
    out = torch.einsum("ecf,efd->ecd", act, p["w_down"].to(cdt)).reshape(spill, D)

    src = flat * cap + torch.clamp(r.slot, max=cap - 1)
    gathered = out[src].masked_fill(~r.keep[:, None], 0)
    gathered = (gathered * r.weights.reshape(-1).to(cdt)[:, None]).view(T, k, D)
    y = gathered[:, 0]
    for j in range(1, k):
        y = y + gathered[:, j]
    y = y.reshape(B, S, D)
    if cfg.dense_residual:
        y = y + mlp_apply(cfg, p["dense"], x)
    return y, {"load_balance": lb_loss, "router_z": z_loss}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD, chunked matmul form)
# ---------------------------------------------------------------------------


def _a_log_init(gen, shape, dtype, device, fan_in=None):
    """log(linspace(1, 16, H)): the per-head decay rates of Mamba-2."""
    return torch.log(torch.linspace(1.0, 16.0, shape[0], device=device)).to(dtype)


def build_ssd(b: Builder, cfg: ModelConfig) -> Params:
    D = cfg.d_model
    di = cfg.ssm_d_inner
    N = cfg.ssm_state
    H = cfg.ssm_num_heads
    convC = di + 2 * N
    f32 = torch.float32
    with b.scope("ssd"):
        return {
            "w_in_x": b.param("w_in_x", (D, di), ("embed", "ssm_inner_tp"),
                              he_normal, fan_in=D),
            "w_in_z": b.param("w_in_z", (D, di), ("embed", "ssm_inner_tp"),
                              he_normal, fan_in=D),
            "w_in_B": b.param("w_in_B", (D, N), ("embed", "ssm_state"),
                              he_normal, fan_in=D),
            "w_in_C": b.param("w_in_C", (D, N), ("embed", "ssm_state"),
                              he_normal, fan_in=D),
            "w_in_dt": b.param("w_in_dt", (D, H), ("embed", "ssm_heads"),
                               he_normal, fan_in=D),
            "dt_bias": b.param("dt_bias", (H,), ("ssm_heads",), zeros_init,
                               dtype=f32),
            "a_log": b.param("a_log", (H,), ("ssm_heads",), _a_log_init,
                             dtype=f32),
            "d_skip": b.param("d_skip", (H,), ("ssm_heads",), ones_init,
                              dtype=f32),
            "conv_w": b.param("conv_w", (cfg.conv_kernel, convC),
                              ("conv_k", "ssm_inner_tp"), normal_init(0.1)),
            "conv_b": b.param("conv_b", (convC,), ("ssm_inner_tp",), zeros_init),
            "w_out": b.param("w_out", (di, D), ("ssm_inner_tp", "embed"),
                             he_normal, fan_in=di),
            "norm": build_rmsnorm(b, "gated_norm", di),
        }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b_: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x: (B,S,C), w: (k,C). Sums in f32, result
    in x's dtype."""
    k = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return (out + b_.float()).to(x.dtype)


def _ssd_in(cfg: ModelConfig, p: Params, x: torch.Tensor):
    """The five input projections in the compute dtype: x, z, B, C, dt."""
    cdt = cfg.compute_torch_dtype()
    return tuple(x @ p[name].to(cdt)
                 for name in ("w_in_x", "w_in_z", "w_in_B", "w_in_C", "w_in_dt"))


def _gated_out(cfg: ModelConfig, p: Params, y: torch.Tensor, z: torch.Tensor
               ) -> torch.Tensor:
    """rmsnorm(y * silu(z)) @ w_out, in the compute dtype."""
    cdt = cfg.compute_torch_dtype()
    y = rmsnorm(p["norm"], y.to(cdt) * F.silu(z), cfg.norm_eps)
    return y @ p["w_out"].to(cdt)


def ssd_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
              return_state: bool = False):
    """Chunked SSD. x: (B,S,D) -> (B,S,D) [, final cache state].

    The intra-chunk block (JAX ``layers.py:655-663``, written inline
    there) is one call of the SSD kernel's wrapper; the inter-chunk
    recurrence over the chunks' (B,H,N,P) states stays a short loop."""
    B, S, _ = x.shape
    di, N, H, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    Q = min(cfg.ssm_chunk, S)
    pad = (-S) % Q
    nc = (S + pad) // Q

    xs, z, Bm, Cm, dt = _ssd_in(cfg, p, x)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out = F.silu(_causal_conv(conv_in, p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = conv_out[..., :di], conv_out[..., di:di + N], conv_out[..., di + N:]

    dt = F.softplus(dt.float() + p["dt_bias"])                          # (B,S,H)
    A = -torch.exp(p["a_log"])                                           # (H,)
    dA = dt * A                                                          # log-decay

    if pad:
        xs, Bm, Cm, dt, dA = (F.pad(t, (0, 0, 0, pad)) for t in (xs, Bm, Cm, dt, dA))

    xh = xs.reshape(B, nc, Q, H, P)                  # a strided view when unpadded
    Bc = Bm.reshape(B, nc, Q, N).float()
    Cc = Cm.reshape(B, nc, Q, N).float()
    dtc = dt.reshape(B, nc, Q, H)
    dAc = dA.reshape(B, nc, Q, H)

    y_diag, chunk_states, decays = ssd_chunk(Cc, Bc, xh, dtc, dAc)
    cum = torch.cumsum(dAc, dim=2)                                       # (B,nc,Q,H)

    state = torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = state * decays[:, c, :, None, None] + chunk_states[:, c]
    prev_states = torch.stack(prev, dim=1)                               # (B,nc,H,N,P)

    y_off = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cc, prev_states, torch.exp(cum))
    y = (y_diag + y_off).reshape(B, nc * Q, H, P)[:, :S]
    y = y + xs.reshape(B, nc * Q, H, P)[:, :S].float() * p["d_skip"][:, None]
    out = _gated_out(cfg, p, y.reshape(B, S, di), z)
    if return_state:
        k = cfg.conv_kernel
        conv_tail = F.pad(conv_in, (0, 0, k - 1, 0))[:, S:S + k - 1]
        return out, {"state": state, "conv": conv_tail}
    return out


def init_ssd_cache(cfg: ModelConfig, batch: int, device: torch.device
                   ) -> Dict[str, torch.Tensor]:
    H, N, P = cfg.ssm_num_heads, cfg.ssm_state, cfg.ssm_head_dim
    convC = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return {
        "state": torch.zeros((batch, H, N, P), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, convC),
                            dtype=cfg.compute_torch_dtype(), device=device),
    }


def ssd_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
               cache: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token SSD step. x: (B,1,D). Returns the output and a new
    state and conv window (the cache passed in is not written)."""
    B = x.shape[0]
    di, N, H, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    xs, z, Bm, Cm, dt = _ssd_in(cfg, p, x[:, 0])

    conv_in = torch.cat([xs, Bm, Cm], dim=-1)                          # (B,convC)
    window = torch.cat([cache["conv"], conv_in[:, None]], dim=1)       # (B,k,convC)
    conv_out = (torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float())
                + p["conv_b"].float())
    conv_out = F.silu(conv_out)                                        # f32, as JAX
    xs = conv_out[:, :di].reshape(B, H, P)
    Bm = conv_out[:, di:di + N]
    Cm = conv_out[:, di + N:]

    dt = F.softplus(dt.float() + p["dt_bias"])                        # (B,H)
    A = -torch.exp(p["a_log"])
    dA = torch.exp(dt * A)                                             # (B,H)
    xdt = xs * dt[..., None]                                           # (B,H,P)
    state = (cache["state"] * dA[..., None, None]
             + torch.einsum("bn,bhp->bhnp", Bm, xdt))
    y = torch.einsum("bn,bhnp->bhp", Cm, state) + xs * p["d_skip"][:, None]
    out = _gated_out(cfg, p, y.reshape(B, di), z)[:, None]
    return out, {"state": state, "conv": window[:, 1:].to(cache["conv"].dtype)}


def ssd_decode_chunk(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache: Dict[str, torch.Tensor], adv: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequential SSD decode over a chunk. x: (B,C,D); adv: (B,).

    State/conv updates are gated per token to ``j < adv`` so padded rows
    of a mixed prefill/decode chunk never advance a slot's recurrence.
    Returns the outputs and the new state (the cache passed in is not
    written)."""
    B, C, _ = x.shape

    def gate(keep: torch.Tensor, new: Dict[str, torch.Tensor],
             old: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {key: torch.where(keep.reshape((B,) + (1,) * (new[key].dim() - 1)),
                                 new[key], old[key])
                for key in new}

    st = cache
    ys = []
    for j in range(C):
        yj, ns = ssd_decode(cfg, p, x[:, j:j + 1], st)
        st = gate(adv > j, ns, st)
        ys.append(yj)
    return torch.cat(ys, dim=1), st

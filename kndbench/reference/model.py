"""Plain PyTorch references of the benchmark's two model families.

Written from the published descriptions, in float32 with TF32 off, and
independent of the program: no kernel, cache, batching or helper of
``repro_torch`` is used or imported. They read the benchmark's weight
tree (the layout of the program's parameter tree, layers stacked on a
leading dim) and the model's config dict from the benchmark's config
file, and work everything else out again.

- Dense decoder (h2o-danube-1.8b; arXiv:2401.16818): token embedding;
  per layer x += attn(rmsnorm(x)), x += swiglu(rmsnorm(x)); final
  rmsnorm; LM head. Attention is GQA with rotary embeddings (the
  half-split rotation, base ``rope_theta``), causal and within the
  sliding window, softmax over d^-1/2-scaled scores.
- Mamba-2 (mamba2-780m; arXiv:2405.21060): per layer x += mixer(rmsnorm(x))
  with in-projections x, z, B, C, dt; a depthwise causal conv over
  [x | B | C] and SiLU; dt = softplus(dt + dt_bias), A = -exp(a_log); the
  SSD y = SSD(x dt, A dt, B, C) + D x computed by the paper's chunked
  algorithm (its ``ssd_minimal_discrete`` listing, exact for any chunk
  length); out = rmsnorm(y * silu(z)) @ w_out. The head is the
  embedding's transpose (tied).

``prec="fp8"`` is the control: every input of a linear layer's product
(activations and weights, the LM head's too) is rounded to float8 e4m3
with a per-tensor scale, the step below the configuration's bf16.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

F32 = torch.float32
FP8_MAX = 448.0


def no_tf32() -> None:
    """Products in true float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes straight through."""
    with torch.no_grad():
        scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).to(F32) * scale
    return x + (q - x).detach()


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, ...) in f32, inputs rounded for ``prec``."""
    w = w.to(F32)
    if prec == "fp8":
        x, w = _fp8(x), _fp8(w)
    elif prec != "f32":
        raise ValueError(f"unknown precision {prec!r}")
    return torch.tensordot(x, w, dims=1)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.to(F32)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B,S,H,d) rotated by position: pairs (i, i + d/2)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=F32, device=x.device) / half)
    ang = pos.to(F32)[:, None] * inv[None, :]                     # (S, half)
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: int) -> torch.Tensor:
    """q (B,S,H,d), k and v (B,S,K,d): query head h reads kv head h // (H/K)."""
    H, K, d = q.shape[2], k.shape[2], q.shape[3]
    k = k.repeat_interleave(H // K, dim=2)
    v = v.repeat_interleave(H // K, dim=2)
    S = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    i = torch.arange(S, device=q.device)
    mask = i[None, :] <= i[:, None]
    if window > 0:
        mask = mask & (i[None, :] > i[:, None] - window)
    s = s.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def dense_layer(m: Dict, lp: Dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)
    a = lp["attn"]
    h = rmsnorm(x, lp["norm1"]["scale"], m["norm_eps"])
    q = rope(linear(h, a["wq"], prec), pos, m["rope_theta"])
    k = rope(linear(h, a["wk"], prec), pos, m["rope_theta"])
    v = linear(h, a["wv"], prec)
    o = attention(q, k, v, m.get("sliding_window") or 0)
    x = x + linear(o.flatten(2), a["wo"].flatten(0, 1), prec)
    h = rmsnorm(x, lp["norm2"]["scale"], m["norm_eps"])
    f = lp["mlp"]
    g = F.silu(linear(h, f["w_gate"], prec)) * linear(h, f["w_up"], prec)
    return x + linear(g, f["w_down"], prec)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): out[i, j] = x[j+1] + ... + x[i] for i >= j,
    -inf above the diagonal (the paper's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    cs = torch.cumsum(x.masked_fill(~below, 0), dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device))
    return cs.masked_fill(~keep, float("-inf"))


def ssd(X, A, B, C, block: int) -> torch.Tensor:
    """The SSD of arXiv:2405.21060 by chunks of ``block``: X (b,l,h,p) the
    inputs times dt, A (b,l,h) the log-decays A dt, B and C (b,l,n) shared
    by every head; zero initial state. Returns Y (b,l,h,p)."""
    b, l, h, p = X.shape
    pad = (-l) % block
    if pad:
        X, A, B, C = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (X, A, B, C))
    c = X.shape[1] // block
    X = X.reshape(b, c, block, h, p)
    B = B.reshape(b, c, block, -1)
    C = C.reshape(b, c, block, -1)
    A = A.reshape(b, c, block, h).permute(0, 3, 1, 2)              # (b,h,c,l)
    A_cum = torch.cumsum(A, dim=-1)
    L = torch.exp(_segsum(A))                                       # (b,h,c,l,s)
    CB = torch.einsum("bcln,bcsn->bcls", C, B)
    Y_diag = torch.einsum("bcls,bhcls,bcshp->bclhp", CB, L, X)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)               # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(_segsum(F.pad(A_cum[..., -1], (1, 0))))  # (b,h,c+1,c+1)
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", C, states, torch.exp(A_cum))
    return (Y_diag + Y_off).reshape(b, c * block, h, p)[:, :l]


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: out[t] = sum_i w[i] x[t - (k-1) + i] + bias."""
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i].to(F32) for i in range(k))
    return out + bias.to(F32)


def ssm_layer(m: Dict, lp: Dict, x: torch.Tensor, prec: str) -> torch.Tensor:
    p = lp["ssd"]
    di = m["ssm_expand"] * m["d_model"]
    N, P = m["ssm_state"], m["ssm_head_dim"]
    H = di // P
    b, S, _ = x.shape
    h = rmsnorm(x, lp["norm1"]["scale"], m["norm_eps"])
    xs, z, Bm, Cm, dt = (linear(h, p[n], prec)
                         for n in ("w_in_x", "w_in_z", "w_in_B", "w_in_C", "w_in_dt"))
    conv = F.silu(causal_conv(torch.cat([xs, Bm, Cm], dim=-1), p["conv_w"], p["conv_b"]))
    xs, Bm, Cm = conv[..., :di], conv[..., di:di + N], conv[..., di + N:]
    dt = F.softplus(dt + p["dt_bias"].to(F32))                      # (b,S,H)
    A = -torch.exp(p["a_log"].to(F32))
    xh = xs.reshape(b, S, H, P)
    y = ssd(xh * dt[..., None], A * dt, Bm, Cm, m["ssm_chunk"])
    y = y + xh * p["d_skip"].to(F32)[:, None]
    y = rmsnorm(y.reshape(b, S, di) * F.silu(z), p["norm"]["scale"], m["norm_eps"])
    return x + linear(y, p["w_out"], prec)


def layer_fn(m: Dict) -> Callable:
    return ssm_layer if m["family"] == "ssm" else dense_layer


def layer_params(params: Dict, li: int) -> Dict:
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[li]
    return pick(params["layers"])


def head_weight(m: Dict, params: Dict) -> torch.Tensor:
    return params["embed"].t() if m.get("tie_embeddings") else params["head"]


def hidden(m: Dict, params: Dict, tokens: torch.Tensor, prec: str,
           checkpointed: bool = False) -> torch.Tensor:
    """Final-normed hidden states (B,S,D) of tokens (B,S)."""
    x = F.embedding(tokens.long(), params["embed"]).to(F32)
    fn = layer_fn(m)
    for li in range(m["num_layers"]):
        lp = layer_params(params, li)
        if checkpointed:
            x = torch.utils.checkpoint.checkpoint(
                lambda x_, lp_: fn(m, lp_, x_, prec), x, lp, use_reentrant=False)
        else:
            x = fn(m, lp, x, prec)
    return rmsnorm(x, params["final_norm"]["scale"], m["norm_eps"])


def logits_at(m: Dict, params: Dict, tokens: torch.Tensor, positions: torch.Tensor,
              prec: str = "f32") -> torch.Tensor:
    """Next-token logits (n, V) of one sequence ``tokens`` (S,) at ``positions``."""
    with torch.no_grad():
        x = hidden(m, params, tokens[None], prec)[0, positions.long()]
        return linear(x, head_weight(m, params), prec)


def loss(m: Dict, params: Dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: str = "f32", checkpointed: bool = True) -> torch.Tensor:
    """Mean next-token cross entropy over every position of (B,S) rows."""
    x = hidden(m, params, tokens, prec, checkpointed)
    logits = linear(x, head_weight(m, params), prec)
    return F.cross_entropy(logits.flatten(0, 1), labels.long().flatten())


def f32_tree(tree: Dict, requires_grad: bool = False) -> Dict:
    """A float32 copy of a weight tree."""
    if isinstance(tree, dict):
        return {k: f32_tree(v, requires_grad) for k, v in tree.items()}
    return tree.detach().to(F32).clone().requires_grad_(requires_grad)



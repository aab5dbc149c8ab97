"""The work an algorithm needs, counted from shapes: the yardstick of the
benchmark's MFU and roofline metrics.

Useful model FLOPs are the matrix-product FLOPs the architecture needs:
2 per weight per token processed, attention's QK^T and PV over the keys
each query really attends (causality and the window honoured), and the
SSD's chunked products as arXiv:2405.21060 states them. Recompute,
padding rows and rows whose result no token needs are not counted.
A kernel's least time is the larger of its FLOPs at the operands'
tensor-core peak and its bytes at HBM bandwidth, each input read once
and each output written once.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

from . import peaks


def _ssm_inner(m: Dict) -> int:
    return m["ssm_expand"] * m["d_model"]


def layer_matmul_params(m: Dict) -> int:
    """Weights of one layer that a token multiplies (norm scales, biases
    and the SSD's per-head scalars and depthwise conv are not products)."""
    D = m["d_model"]
    if m["family"] == "ssm":
        di, N = _ssm_inner(m), m["ssm_state"]
        H = di // m["ssm_head_dim"]
        return D * (2 * di + 2 * N + H) + di * D
    H, K = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or D // H
    attn = D * H * hd + 2 * D * K * hd + H * hd * D
    mlp = (3 if m.get("act", "swiglu") in ("swiglu", "geglu") else 2) * D * m["d_ff"]
    return attn + mlp


def head_params(m: Dict) -> int:
    return m["d_model"] * m["vocab_size"]


def matmul_params(m: Dict) -> int:
    """Weights a token multiplies through the whole model: every layer and
    the LM head; the embedding is a lookup and is not counted."""
    return m["num_layers"] * layer_matmul_params(m) + head_params(m)


def attention_flops(m: Dict, n_keys: int) -> int:
    """QK^T and PV of one query against ``n_keys`` keys, in one layer."""
    H = m["num_heads"]
    hd = m.get("head_dim") or m["d_model"] // H
    return 4 * H * hd * n_keys


def causal_key_sum(m: Dict, start: int, stop: int) -> int:
    """How many keys the queries at positions ``start .. stop-1`` attend in
    all: causal, and within the sliding window where the model has one."""
    w = m.get("sliding_window") or 0

    def upto(n: int) -> int:        # sum over positions 0 .. n-1
        if w <= 0 or n <= w:
            return n * (n + 1) // 2
        return w * (w + 1) // 2 + (n - w) * w
    return upto(stop) - upto(start)


def ssd_flops_per_token(m: Dict) -> int:
    """The chunked SSD's products per token in one layer (arXiv:2405.21060,
    section 6): C.B^T within a chunk (shared by the heads, lower triangle),
    the masked product with x per head (lower triangle), each chunk's
    state B^T x and the output from the state C h, per head."""
    Q, N, P = m["ssm_chunk"], m["ssm_state"], m["ssm_head_dim"]
    H = _ssm_inner(m) // P
    tri = Q + 1                       # 2 * (Q+1)/2: the triangle's average row
    return N * tri + H * (P * tri + 4 * N * P)


def forward_flops(m: Dict, seq_lens: Sequence[int]) -> int:
    """One forward pass over whole sequences of the given lengths, every
    position scored by the LM head (as training needs)."""
    total = 0
    for S in seq_lens:
        total += 2 * matmul_params(m) * S
        if m["family"] == "ssm":
            total += m["num_layers"] * ssd_flops_per_token(m) * S
        else:
            total += m["num_layers"] * attention_flops(m, 1) * causal_key_sum(m, 0, S)
    return total


def train_step_flops(m: Dict, batch: int, seq_len: int) -> int:
    """Forward and backward (twice the forward) of one optimizer step."""
    return 3 * forward_flops(m, [seq_len] * batch)


def serve_chunk_flops(m: Dict, pos: int, n: int, sampled: bool) -> int:
    """Forward work of feeding ``n`` tokens at positions pos .. pos+n-1 of
    one request, with the LM head on the last of them only when a token is
    sampled from it (a prompt chunk that does not end the prompt samples
    nothing). Dense models only: the serving cells run attention."""
    L = m["num_layers"]
    body = 2 * (matmul_params(m) - head_params(m)) * n
    attn = L * attention_flops(m, 1) * causal_key_sum(m, pos, pos + n)
    return body + attn + (2 * head_params(m) if sampled else 0)


def _numel(shape: Iterable[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def least_time(flops: float, nbytes: float, dtype: str) -> float:
    """Seconds the card needs at least: FLOPs at the operands' peak or
    bytes at HBM bandwidth, whichever is longer."""
    return max(flops / peaks.matmul_peak(dtype), nbytes / peaks.HBM_BYTES_PER_S)


def flash_fwd_work(q_shape, k_shape, dtype: str, window: int, causal: bool = True):
    """(FLOPs, bytes) of one attention forward: q (B,S,H,d), k and v
    (B,S,K,d), out (B,S,H,d); QK^T and PV over the keys each query
    attends."""
    B, S, H, d = (int(s) for s in q_shape)
    if causal:
        keys = causal_key_sum({"sliding_window": window}, 0, S)
    else:
        keys = S * S
    flops = 4 * B * H * d * keys
    esz = peaks.DTYPE_BYTES[dtype]
    nbytes = esz * (2 * _numel(q_shape) + 2 * _numel(k_shape))
    return flops, nbytes


def ssd_chunk_work(C_shape, x_shape, x_dtype: str):
    """(FLOPs, bytes) of one SSD intra-chunk call: C, B (b,nc,Q,N) f32, x
    (b,nc,Q,H,P), dt and da (b,nc,Q,H) f32 in; y_diag (b,nc,Q,H,P),
    states (b,nc,H,N,P) and decays (b,nc,H) f32 out. The products: C.B^T
    per chunk (lower triangle), the masked product with x per head (lower
    triangle), and the chunk's state B^T x per head."""
    b, nc, Q, N = (int(s) for s in C_shape)
    H, P = int(x_shape[3]), int(x_shape[4])
    tri = Q * (Q + 1)                  # 2 * Q(Q+1)/2
    flops = b * nc * (N * tri + H * (P * tri + 2 * Q * N * P))
    f4 = 4
    x_bytes = peaks.DTYPE_BYTES[x_dtype] * _numel(x_shape)
    nbytes = (2 * f4 * b * nc * Q * N + x_bytes + 2 * f4 * b * nc * Q * H
              + f4 * _numel(x_shape) + f4 * b * nc * H * N * P + f4 * b * nc * H)
    return flops, nbytes

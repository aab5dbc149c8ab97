"""The paged decode-attention wrapper on the CPU.

``attention_decode_paged`` routes its attention through
``kernels.paged_attention.ops.paged_attention``, whose CPU path is the
plain version the layer computed inline before the kernel existed. Here
the layer is held bit for bit, output and pool, to that inline version
(kept below as ``_inline_decode_paged``) on mixed ticks: decode rows,
whole and partial prefill chunks, idle slots, shuffled block tables with
sentinel entries, a write into a sentinel block (dropped) and positions
crossing the window. The kernel itself runs on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""

import math
import re
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.kernels.paged_attention.paged_attention import (
    _ARGS, HEAD_DIMS, MAX_SPLITS, SOURCE, key_splits, paged_attention_fwd)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_neg_inf, _project_qkv, apply_rope,
                                       attention_decode_paged, rope_table)


def _inline_decode_paged(cfg, p, x, kv, block_table, pos, adv):
    """``attention_decode_paged`` as it was before the kernel: every
    slot's whole table gathered, f32 scores, one softmax, the pool write."""
    B, C, _ = x.shape
    cdt = cfg.compute_torch_dtype()
    bs = kv["k"].shape[1]
    nb = block_table.shape[1]
    S = nb * bs
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    dev = x.device

    jj = torch.arange(C, dtype=pos.dtype, device=dev)
    qpos = pos[:, None] + jj[None, :]
    q, k, v = _project_qkv(cfg, p, x)
    cos, sin = rope_table(qpos, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    ck = kv["k"][block_table.long()].reshape(B, S, K, hd).to(cdt)
    cv = kv["v"][block_table.long()].reshape(B, S, K, hd).to(cdt)
    kpos = torch.arange(S, dtype=pos.dtype, device=dev)
    mask_res = kpos[None, None, :] < pos[:, None, None]
    mask_res = mask_res.expand(B, C, S)
    mask_chunk = (jj[None, :] <= jj[:, None])[None]
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
    scores = torch.cat([s_res, s_chk], dim=-1)
    w = torch.softmax(scores, dim=-1).to(cdt)
    out = (torch.einsum("bkgqs,bskh->bqkgh", w[..., :S], cv)
           + torch.einsum("bkgqs,bskh->bqkgh", w[..., S:], v))
    out = out.reshape(B, C, H, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cdt))

    lb = torch.clamp(torch.div(qpos, bs, rounding_mode="floor"), 0, nb - 1)
    blk = torch.gather(block_table.long(), 1, lb.long())
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


BS, NB_SLOT, K = 4, 8, 2            # tokens per block, table width, KV heads
WINDOW = 12                          # under most slots' positions
# (pos, adv) per slot of a chunk of C = 8: decode, whole prefill, idle at 0,
# partial prefill, a whole chunk crossing the window, a partial chunk
# whose write lands in a sentinel block (dropped), an idle slot mid-request
MIXED = [(13, 1), (0, 8), (0, 0), (8, 5), (21, 8), (16, 3), (9, 0)]
# C = 1: decode rows beside idle slots (a window-crossing clock included)
DECODE = [(13, 1), (0, 0), (20, 1), (31, 1), (5, 0), (1, 1)]


def _tick(G, dtype, window, slots, C, seed):
    rng = np.random.RandomState(seed)
    H, hd, D = G * K, 16, 32
    cfg = ModelConfig(num_heads=H, num_kv_heads=K, head_dim=hd, d_model=D,
                      sliding_window=window, compute_dtype=str(dtype).replace("torch.", ""),
                      param_dtype=str(dtype).replace("torch.", ""))

    def t(*shape, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale).to(dtype)

    p = {"wq": t(D, H, hd, scale=D ** -0.5), "wk": t(D, K, hd, scale=D ** -0.5),
         "wv": t(D, K, hd, scale=D ** -0.5), "wo": t(H, hd, D, scale=(H * hd) ** -0.5)}
    B = len(slots)
    NB = B * NB_SLOT + 1
    perm = rng.permutation(np.arange(1, NB))         # shuffled, non-contiguous blocks
    table = np.zeros((B, NB_SLOT), np.int32)
    for b, (pos, adv) in enumerate(slots):
        used = -(-(pos + adv) // BS) if adv else -(-pos // BS)
        table[b, :used] = perm[b * NB_SLOT:b * NB_SLOT + used]   # the rest: sentinel 0
    if slots is MIXED:
        table[5, 16 // BS] = 0                        # slot 5's write target: sentinel
    pool = {n: t(NB, BS, K, hd) for n in ("k", "v")}
    for a in pool.values():
        a[0] = 0                                      # the sentinel block is zero
    x = t(B, C, D)
    pos = torch.tensor([s[0] for s in slots], dtype=torch.int32)
    adv = torch.tensor([s[1] for s in slots], dtype=torch.int32)
    return cfg, p, x, pool, torch.from_numpy(table), pos, adv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("G", [1, 4, 5, 7])
@pytest.mark.parametrize("window", [0, WINDOW])
@pytest.mark.parametrize("tick", ["mixed", "decode"])
def test_plain_version_equals_the_inline_attention_bit_for_bit(dtype, G, window, tick):
    slots, C = (MIXED, 8) if tick == "mixed" else (DECODE, 1)
    cfg, p, x, pool, table, pos, adv = _tick(G, dtype, window, slots, C, seed=G + window)
    want_pool = {n: a.clone() for n, a in pool.items()}
    want, _ = _inline_decode_paged(cfg, p, x, want_pool, table, pos, adv)
    got, got_pool = attention_decode_paged(cfg, p, x, pool, table, pos, adv)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    for n in ("k", "v"):
        assert torch.equal(got_pool[n], want_pool[n])
    assert torch.count_nonzero(got_pool["k"][0]) == 0      # the sentinel stays zero


def test_cpu_path_counts_no_paged_launch():
    reset_launch_counts()
    cfg, p, x, pool, table, pos, adv = _tick(4, torch.float32, WINDOW, MIXED, 8, seed=0)
    attention_decode_paged(cfg, p, x, pool, table, pos, adv)
    assert paged_ops.launches == 0
    assert launch_counts()["paged_attention"] == 0


def test_wrapper_raises_on_a_device_without_a_kernel():
    q = torch.empty(2, 4, 8, 64, device="meta")
    k = torch.empty(2, 4, 2, 64, device="meta")
    pool = torch.empty(9, 4, 2, 64, device="meta")
    i = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        paged_ops.paged_attention(q, k, k, pool, pool, torch.zeros(2, 4, dtype=torch.int32,
                                                                    device="meta"), i, i)


def test_wrapper_raises_on_a_tensor_subclass_on_cuda():
    """A fake (or sharded) CUDA tensor gets no plain-version fallback:
    no engine path traces or shards the paged pool."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        q = torch.empty(2, 4, 8, 64, dtype=torch.bfloat16, device="cuda")
        k = torch.empty(2, 4, 2, 64, dtype=torch.bfloat16, device="cuda")
        pool = torch.empty(9, 4, 2, 64, dtype=torch.bfloat16, device="cuda")
        i = torch.zeros(2, dtype=torch.int32, device="cuda")
        table = torch.zeros(2, 4, dtype=torch.int32, device="cuda")
    before = paged_ops.launches
    with pytest.raises(TypeError, match="plain CUDA tensors, not \\['FakeTensor'\\]"):
        paged_ops.paged_attention(q, k, k, pool, pool, table, i, i)
    assert paged_ops.launches == before


@pytest.mark.parametrize("hd", [48, 96, 256])
def test_binding_raises_on_a_head_dim_not_built(hd):
    q = torch.zeros(2, 4, 8, hd)
    k = torch.zeros(2, 4, 2, hd)
    pool = torch.zeros(9, 4, 2, hd)
    i = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"head_dim {hd} not built"):
        paged_attention_fwd(q, k, k, pool, pool, torch.zeros(2, 4, dtype=torch.int32), i, i)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_binding_checks_the_device_after_the_shapes(hd):
    """A built head dim gets past the shape checks to the device check:
    CPU tensors never reach the library."""
    q = torch.zeros(2, 4, 8, hd, dtype=torch.bfloat16)
    k = torch.zeros(2, 4, 2, hd, dtype=torch.bfloat16)
    pool = torch.zeros(9, 4, 2, hd, dtype=torch.bfloat16)
    i = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_attention_fwd(q, k, k, pool, pool, torch.zeros(2, 4, dtype=torch.int32), i, i)


def test_binding_raises_on_mixed_dtypes():
    q = torch.zeros(2, 4, 8, 64, dtype=torch.bfloat16)
    k = torch.zeros(2, 4, 2, 64, dtype=torch.bfloat16)
    pool = torch.zeros(9, 4, 2, 64)
    i = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError, match="all equal"):
        paged_attention_fwd(q, k, k, pool, pool, torch.zeros(2, 4, dtype=torch.int32), i, i)


@pytest.mark.parametrize("blocks,max_tiles,sms,want", [
    (512, 66, 132, 1),        # danube-rag's tick: 64 slots x 8 KV heads
    (264, 66, 132, 1),        # exactly two blocks per SM
    (40, 66, 132, 7),         # 5 slots x 8: ceil(264 / 40)
    (8, 66, 132, MAX_SPLITS),
    (8, 3, 132, 3),           # no more splits than key tiles
    (1, 1, 132, 1),
])
def test_key_splits(blocks, max_tiles, sms, want):
    assert key_splits(blocks, max_tiles, sms) == want


def test_launch_struct_matches_the_source():
    """The Python struct of the launch's arguments has the size and the
    field offsets that the CUDA source's static_asserts pin PagedArgs to."""
    src = SOURCE.read_text()
    pinned = {m[0]: int(m[1]) for m in re.findall(
        r"static_assert\((?:sizeof\(PagedArgs\)|offsetof\(PagedArgs, (\w+)\)) == (\d+)", src)}
    assert pinned == {"": 240, "B": 192, "scale": 232}
    assert _ARGS.size == pinned[""]
    packed = _ARGS.pack(*range(1, 25), 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 0.25)
    assert struct.unpack_from("<i", packed, pinned["B"])[0] == 7
    assert struct.unpack_from("<f", packed, pinned["scale"])[0] == 0.25

"""The port's SSD (Mamba-2) block against the JAX package's, on the CPU.

* the plain version of the SSD kernel against the JAX wrapper (the
  Pallas kernel in interpret mode, as ``test_kernels.py`` runs it) and
  the JAX oracle, on the cases of ``test_kernels.py``, at its bound of
  1e-4 abs; and at mamba2-like decays (``da = dt * A`` with A down to
  -16) at a relative bound;
* ``ssd_apply`` with and without its final state (S not a multiple of
  the chunk, so the padding runs), ``ssd_decode`` and
  ``ssd_decode_chunk`` with mixed ``adv``, at 1e-4 relative in f32;
* the SSD parameters' init, and the ``launch.serve`` entry point for
  mamba2-780m;
* the CUDA kernel's arithmetic, 3xTF32 on tensor cores, emulated in
  plain torch (operands rounded to TF32 by bit masking, f32 sums) on its
  three products, held to the kernel's bounds; and single-pass TF32,
  which misses them;
* the binding's Python side: which inputs its 16-byte copies read in
  place, the padded copies of the others, the two scratch shapes and
  the inputs it refuses before anything is built.

The CUDA kernel itself is held against the plain version on the card by
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.kernels.ssd_scan.ops import ssd_chunk as jax_ssd_chunk
from repro.kernels.ssd_scan.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.modules import Builder as JBuilder, Mode as JMode
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.ssd_scan.ops import ssd_chunk
from repro_torch.models import layers as L
from repro_torch.models import lm


def f32(cfg):
    return cfg.replace(compute_dtype="float32", param_dtype="float32")


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def chunk_inputs(rng, b, nc, Q, N, H, P, da_scale=0.1):
    """The distribution of ``test_kernels.py``: unit normals,
    dt = softplus(n), da = -|n| * da_scale."""
    C = rng.randn(b, nc, Q, N).astype(np.float32)
    B = rng.randn(b, nc, Q, N).astype(np.float32)
    x = rng.randn(b, nc, Q, H, P).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, nc, Q, H))).astype(np.float32)
    da = (-np.abs(rng.randn(b, nc, Q, H)) * da_scale).astype(np.float32)
    return C, B, x, dt, da


# ---------------------------------------------------------------------------
# The kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,nc,Q,N,H,P", [
    (2, 3, 16, 8, 4, 16),
    (1, 2, 32, 16, 2, 8),
    (1, 1, 64, 32, 3, 16),
])
def test_plain_ssd_chunk_matches_jax(b, nc, Q, N, H, P, x_dtype):
    C, B, x, dt, da = chunk_inputs(np.random.RandomState(Q + N), b, nc, Q, N, H, P)
    jx = jnp.asarray(x).astype(x_dtype)
    tx = convert.tensor_from_numpy(np.asarray(jx), device="cpu")
    got = ssd_chunk(t(C), t(B), tx, t(dt), t(da))
    for want in (jax_ssd_chunk(*map(jnp.asarray, (C, B)), jx, *map(jnp.asarray, (dt, da))),
                 jax_ssd_chunk_ref(*map(jnp.asarray, (C, B)), jx,
                                   *map(jnp.asarray, (dt, da)))):
        for o, w in zip(got, want):
            assert o.dtype == torch.float32 and tuple(o.shape) == w.shape
            assert float(np.max(np.abs(o.numpy() - np.asarray(w)))) < 1e-4


def test_plain_ssd_chunk_at_mamba2_like_decays():
    """da = dt * A with A = -linspace(1, 16, H), as mamba2's init gives:
    the segment sums reach the order of -1e2 to -1e3, where f32 cum_i -
    cum_j carries ~1e-5 relative noise between summation orders, hence a
    relative bound."""
    rng = np.random.RandomState(0)
    b, nc, Q, N, H, P = 1, 2, 64, 16, 4, 8
    C, B, x, _, _ = chunk_inputs(rng, b, nc, Q, N, H, P)
    dt = np.log1p(np.exp(rng.randn(b, nc, Q, H))).astype(np.float32)
    da = (dt * -np.linspace(1.0, 16.0, H)).astype(np.float32)
    got = ssd_chunk(t(C), t(B), t(x), t(dt), t(da))
    want = jax_ssd_chunk_ref(*map(jnp.asarray, (C, B, x, dt, da)))
    for o, w in zip(got, want):
        assert rel_err(o.numpy(), w) < 1e-5


def test_cpu_ssd_chunk_reads_strided_views():
    """x as the d_inner slice of a fused (…, d_inner + 2N) tensor, as
    ssd_apply hands it over."""
    rng = np.random.RandomState(1)
    b, nc, Q, N, H, P = 1, 2, 16, 8, 2, 16
    C, B, _, dt, da = chunk_inputs(rng, b, nc, Q, N, H, P)
    fused = t(rng.randn(b, nc, Q, H * P + 2 * N).astype(np.float32))
    x = fused[..., :H * P].reshape(b, nc, Q, H, P)
    assert not x.is_contiguous()
    got = ssd_chunk(t(C), t(B), x, t(dt), t(da))
    want = ssd_chunk(t(C), t(B), x.contiguous(), t(dt), t(da))
    for o, w in zip(got, want):
        assert torch.equal(o, w)


def test_ssd_chunk_wrapper_counts_only_kernel_launches():
    reset_launch_counts()
    C, B, x, dt, da = map(t, chunk_inputs(np.random.RandomState(2), 1, 1, 8, 4, 2, 8))
    ssd_chunk(C, B, x, dt, da)
    assert launch_counts()["ssd_chunk"] == 0
    meta = [a.to("meta") for a in (C, B, x, dt, da)]
    with pytest.raises(ValueError, match="no kernel"):
        ssd_chunk(*meta)


def test_kernel_binding_refuses_cpu_tensors_before_building():
    from repro_torch.kernels.ssd_scan.ssd_scan import ssd_chunk_fwd
    C, B, x, dt, da = map(t, chunk_inputs(np.random.RandomState(3), 1, 1, 8, 4, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd_chunk_fwd(C, B, x, dt, da)


# ---------------------------------------------------------------------------
# The kernel's 3xTF32 arithmetic, emulated
# ---------------------------------------------------------------------------

def tf32(a: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits; ties away from 0,
    as cvt.rna.tf32.f32), by bit masking."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def mm_tf32(a, b):
    """One TF32 tensor-core pass: operands rounded, f32 sums (a product
    of two TF32 values is exact in f32)."""
    return tf32(a) @ tf32(b)


def mm_3xtf32(a, b):
    """The kernel's 3xTF32: a = ab + as, b = bb + bs, each part TF32;
    as.bb + ab.bs first, then ab.bb; as.bs is dropped."""
    ab, bb = tf32(a), tf32(b)
    as_, bs = tf32(a - ab), tf32(b - bb)
    return (as_ @ bb + ab @ bs) + ab @ bb


def chunk_emulated(C, B, x, dt, da, mm):
    """The kernel's three products, each through ``mm``; the scores are
    formed in f32 (C·Bᵀ x exp(cum_i - cum_j), 0 above the diagonal) and
    only then rounded, as the kernel does."""
    C, B, x, dt, da = (t(a).float() for a in (C, B, x, dt, da))
    Q = C.shape[2]
    cum = torch.cumsum(da, dim=2)                                    # (b,nc,Q,H)
    total = cum[:, :, -1]
    cb = mm(C, B.transpose(-1, -2))                                  # (b,nc,Q,Q)
    ct = cum.permute(0, 1, 3, 2)                                     # (b,nc,H,Q)
    lower = torch.ones(Q, Q, dtype=torch.bool).tril()
    L = torch.exp((ct[..., :, None] - ct[..., None, :]).masked_fill(~lower, -torch.inf))
    scores = cb[:, :, None] * L                                      # (b,nc,H,Q,Q)
    xdt = (x * dt[..., None]).permute(0, 1, 3, 2, 4)                # (b,nc,H,Q,P)
    y = mm(scores, xdt).permute(0, 1, 3, 2, 4)
    w = xdt * torch.exp(total[..., None] - ct)[..., None]
    states = mm(B.transpose(-1, -2)[:, :, None], w)                 # (b,nc,H,N,P)
    return y, states, torch.exp(total)


def model_like_inputs(rng, b, nc, Q, N, H, P):
    """Unit normals and mamba2's init decays: da = dt * A, A = -linspace(1, 16, H)."""
    C, B, x, dt, _ = chunk_inputs(rng, b, nc, Q, N, H, P)
    return C, B, x, dt, (dt * -np.linspace(1.0, 16.0, H)).astype(np.float32)


def max_err(got, want, relative):
    """Max abs error over the outputs, or each one's over its own largest
    magnitude (decays underflow to 0 at model-like decays)."""
    errs = []
    for o, w in zip(got, want):
        o, w = o.numpy().astype(np.float64), np.asarray(w, np.float64)
        e = float(np.max(np.abs(o - w)))
        errs.append(e / max(float(np.max(np.abs(w))), 1e-30) if relative else e)
    return max(errs)


@pytest.mark.parametrize("b,nc,Q,N,H,P,da_scale", [
    # the cases of test_kernels.py's TestSsdChunk, then its property test's
    (2, 3, 16, 8, 4, 16, 0.1), (1, 2, 32, 16, 2, 8, 0.1), (1, 1, 64, 32, 3, 16, 0.1),
    (1, 2, 8, 4, 2, 8, 0.05), (1, 2, 32, 4, 2, 16, 0.05), (1, 2, 16, 8, 2, 16, 0.05)])
def test_3xtf32_holds_the_jax_test_bound(b, nc, Q, N, H, P, da_scale):
    ins = chunk_inputs(np.random.RandomState(Q * N * P), b, nc, Q, N, H, P, da_scale)
    want = jax_ssd_chunk_ref(*map(jnp.asarray, ins))
    assert max_err(chunk_emulated(*ins, mm_3xtf32), want, relative=False) < 1e-4


@pytest.mark.parametrize("Q,N,H", [(256, 128, 48), (100, 128, 48), (256, 16, 50),
                                   (100, 16, 50)])
def test_3xtf32_holds_the_relative_bound_at_model_like_decays(Q, N, H):
    """mamba2-780m (N 128, 48 heads) and hymba-1.5b (N 16, 50 heads), P 64,
    a full chunk and a 100-token prompt."""
    ins = model_like_inputs(np.random.RandomState(Q + N), 1, 1, Q, N, H, 64)
    want = jax_ssd_chunk_ref(*map(jnp.asarray, ins))
    assert max_err(chunk_emulated(*ins, mm_3xtf32), want, relative=True) < 1e-3


def test_3xtf32_at_a_full_chunk_of_the_jax_test_distribution_is_held_relative():
    """At mamba2's 256-row chunk the JAX tests' distribution (their tests
    stop at Q = 64) gives outputs past 1e2, where 1e-4 abs is ~2^-21 of
    them: the card checks this shape at the relative bound."""
    ins = chunk_inputs(np.random.RandomState(256), 1, 2, 256, 128, 8, 64)
    want = jax_ssd_chunk_ref(*map(jnp.asarray, ins))
    assert float(np.max(np.abs(np.asarray(want[0])))) > 1e2
    assert max_err(chunk_emulated(*ins, mm_3xtf32), want, relative=True) < 1e-5


def test_single_pass_tf32_misses_the_jax_test_bound():
    """Why the kernel takes 3xTF32: one TF32 pass keeps 10 mantissa bits
    and misses test_kernels.py's 1e-4 by two orders of magnitude."""
    ins = chunk_inputs(np.random.RandomState(64 * 32 * 16), 1, 1, 64, 32, 3, 16)
    want = jax_ssd_chunk_ref(*map(jnp.asarray, ins))
    assert max_err(chunk_emulated(*ins, mm_tf32), want, relative=False) > 1e-3
    assert max_err(chunk_emulated(*ins, mm_3xtf32), want, relative=False) < 1e-4


def test_bf16_x_is_exact_in_tf32_so_two_passes_suffice():
    """Why the kernel issues 2 TF32 passes, not 3, for the products with a
    bf16 x: x's small part is 0, so big.small adds nothing, and the two
    products come out bit-equal to the emulated 3xTF32."""
    rng = np.random.RandomState(9)
    x = t(rng.randn(64, 16).astype(np.float32)).to(torch.bfloat16).float()
    assert torch.equal(tf32(x), x) and not tf32(x - tf32(x)).any()
    a = t(rng.randn(32, 64).astype(np.float32))
    ab = tf32(a)
    two_pass = tf32(a - ab) @ x + ab @ x
    assert torch.equal(two_pass, mm_3xtf32(a, x))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -11, 1 + 2.0 ** -12, -(1 + 2.0 ** -11)])
    assert tf32(a).tolist() == [1.0, 1 + 2.0 ** -10, 1 + 2.0 ** -10, 1.0, -(1 + 2.0 ** -10)]
    v = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(np.float32))
    big = tf32(v)
    assert float(((v - big - tf32(v - big)).abs() / v.abs()).max()) < 2.0 ** -21


# ---------------------------------------------------------------------------
# The binding's Python side
# ---------------------------------------------------------------------------

def test_cp_async_ready_decides_which_inputs_are_read_in_place():
    from repro_torch.kernels.cp_async import cp_async_ready
    assert cp_async_ready(torch.zeros(1, 2, 16, 4))                  # N 4: 16-byte rows
    assert not cp_async_ready(torch.zeros(1, 2, 16, 2))              # rows 8 bytes apart
    assert not cp_async_ready(torch.zeros(1, 2, 16, 4, 4, dtype=torch.bfloat16))
    assert cp_async_ready(torch.zeros(1, 2, 16, 4)[..., :2])         # 8 bytes of 16
    # ssd_apply's views of the conv output (d_inner + 2N per token)
    H, P, N = 4, 16, 8
    conv = torch.zeros(1, 32, H * P + 2 * N, dtype=torch.bfloat16)
    x = conv[..., :H * P].reshape(1, 2, 16, H, P)
    assert not x.is_contiguous() and cp_async_ready(x)
    f32conv = torch.zeros(1, 32, H * P + 2 * N)
    assert cp_async_ready(f32conv[..., H * P:H * P + N].reshape(1, 2, 16, N))
    # off the 16-byte grid: a first element 2 bytes in, a token stride of
    # H * P + 4 bf16 elements (8 bytes off)
    assert not cp_async_ready(conv[..., 1:H * P + 1].reshape(1, 2, 16, H, P))
    odd = torch.zeros(1, 32, H * P + 4, dtype=torch.bfloat16)
    assert not cp_async_ready(odd[..., :H * P].reshape(1, 2, 16, H, P))
    # a stride of a dimension of size 1 is never stepped
    assert cp_async_ready(torch.zeros(1, 3, 16, 4)[:, 1:2])


@pytest.mark.parametrize("case", ["offset", "token_stride", "narrow_rows"])
def test_aligned_input_copies_what_the_kernel_cannot_read(case):
    from repro_torch.kernels.cp_async import aligned_input, cp_async_ready
    rng = np.random.RandomState(5)
    if case == "offset":
        base = t(rng.randn(1, 32, 70).astype(np.float32)).to(torch.bfloat16)
        a = base[..., 1:65].reshape(1, 2, 16, 4, 16)
    elif case == "token_stride":
        base = t(rng.randn(1, 32, 68).astype(np.float32)).to(torch.bfloat16)
        a = base[..., :64].reshape(1, 2, 16, 4, 16)
    else:                                             # N = 2 in f32: 8-byte rows
        a = t(rng.randn(1, 2, 16, 2).astype(np.float32))
    assert not cp_async_ready(a)
    got = aligned_input(a)
    assert cp_async_ready(got) and got.shape == a.shape and torch.equal(got, a)
    if case == "narrow_rows":                         # rows padded to 16 bytes
        assert got.stride() == (128, 64, 4, 1)
    ok = t(rng.randn(1, 2, 16, 8).astype(np.float32))
    assert aligned_input(ok) is ok


def test_scratch_holds_one_padded_square_per_chunk_and_three_rows_per_head():
    from repro_torch.kernels.ssd_scan.ssd_scan import scratch_shapes
    # mamba2, 2048 tokens: C.B^T 2 MB, the aux rows 1.2 MB
    assert scratch_shapes(1, 8, 256, 48) == {"cb": (8, 256, 256), "aux": (8, 48, 3, 256)}
    assert scratch_shapes(2, 3, 100, 50) == {"cb": (6, 128, 128), "aux": (6, 50, 3, 128)}
    assert scratch_shapes(1, 2, 8, 2) == {"cb": (2, 64, 64), "aux": (2, 2, 3, 64)}


@pytest.mark.parametrize("what,shape", [
    ("Q", (1, 1, 512, 16, 2, 16)), ("N", (1, 1, 16, 256, 2, 16)),
    ("P", (1, 1, 16, 16, 2, 128)), ("grid", (1, 65536, 1, 4, 1, 8))])
def test_check_inputs_refuses_shapes_before_building(what, shape):
    from repro_torch.kernels.ssd_scan import ssd_scan
    b, nc, Q, N, H, P = shape
    ins = (torch.zeros(b, nc, Q, N), torch.zeros(b, nc, Q, N), torch.zeros(b, nc, Q, H, P),
           torch.zeros(b, nc, Q, H), torch.zeros(b, nc, Q, H))
    with pytest.raises(ValueError, match="built for" if what != "grid" else "grid"):
        ssd_scan.check_inputs(*ins)
    assert ssd_scan._FN is None                        # nothing was built or loaded


def test_check_inputs_refuses_dtypes_and_layouts():
    from repro_torch.kernels.ssd_scan.ssd_scan import check_inputs
    C, B, x, dt, da = map(t, chunk_inputs(np.random.RandomState(6), 1, 2, 16, 8, 2, 16))
    assert check_inputs(C, B, x, dt, da) == (1, 2, 16, 8, 2, 16)
    assert check_inputs(C, B, x.to(torch.bfloat16), dt, da) == (1, 2, 16, 8, 2, 16)
    with pytest.raises(TypeError):
        check_inputs(C, B, x.half(), dt, da)
    with pytest.raises(TypeError):
        check_inputs(C.double(), B, x, dt, da)
    with pytest.raises(ValueError, match="contiguous"):
        check_inputs(C, B, x.transpose(3, 4).contiguous().transpose(3, 4), dt, da)
    with pytest.raises(ValueError, match="mismatch"):
        check_inputs(C, B[:, :, :8], x, dt, da)


# ---------------------------------------------------------------------------
# The SSD layer
# ---------------------------------------------------------------------------

_LAYER = {}


def ssd_world(chunk=16):
    """(jax cfg, torch cfg, jax params, torch params) of one mamba2 smoke
    SSD layer, with its biases and skip randomized."""
    if chunk not in _LAYER:
        jcfg = f32(jax_smoke_config("mamba2-780m")).replace(ssm_chunk=chunk)
        tcfg = f32(smoke_config("mamba2-780m")).replace(ssm_chunk=chunk)
        tree = jax.tree.map(np.asarray, JL.build_ssd(
            JBuilder(JMode.INIT, jax.random.PRNGKey(0), jnp.float32), jcfg))
        rng = np.random.RandomState(4)
        tree["dt_bias"] = (rng.randn(*tree["dt_bias"].shape) * 0.3).astype(np.float32)
        tree["conv_b"] = (rng.randn(*tree["conv_b"].shape) * 0.1).astype(np.float32)
        tree["d_skip"] = (1 + rng.randn(*tree["d_skip"].shape) * 0.1).astype(np.float32)
        _LAYER[chunk] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                         convert.params_from_jax(tree, "cpu"))
    return _LAYER[chunk]


@pytest.mark.parametrize("S", [7, 16, 20, 45])
def test_ssd_apply_matches_jax(S):
    """S = 7 < Q (one short chunk), 16 = Q, 20 and 45 (padded last chunk)."""
    jcfg, tcfg, jp, tp = ssd_world()
    x = np.random.RandomState(S).randn(2, S, jcfg.d_model).astype(np.float32)
    want = JL.ssd_apply(jcfg, jp, jnp.asarray(x))
    got = L.ssd_apply(tcfg, tp, t(x))
    assert rel_err(got.numpy(), want) < 1e-4
    want_y, want_st = JL.ssd_apply(jcfg, jp, jnp.asarray(x), return_state=True)
    got_y, got_st = L.ssd_apply(tcfg, tp, t(x), return_state=True)
    assert rel_err(got_y.numpy(), want_y) < 1e-4
    for name in ("state", "conv"):
        assert tuple(got_st[name].shape) == want_st[name].shape
        assert rel_err(got_st[name].numpy(), want_st[name]) < 1e-4


def test_ssd_decode_matches_jax():
    jcfg, tcfg, jp, tp = ssd_world()
    rng = np.random.RandomState(8)
    x = rng.randn(3, 1, jcfg.d_model).astype(np.float32)
    cache = {"state": rng.randn(3, jcfg.ssm_num_heads, jcfg.ssm_state,
                                jcfg.ssm_head_dim).astype(np.float32),
             "conv": rng.randn(3, jcfg.conv_kernel - 1,
                               jcfg.ssm_d_inner + 2 * jcfg.ssm_state).astype(np.float32)}
    want, wst = JL.ssd_decode(jcfg, jp, jnp.asarray(x),
                              {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = {k: t(v) for k, v in cache.items()}
    got, gst = L.ssd_decode(tcfg, tp, t(x), tcache)
    assert rel_err(got.numpy(), want) < 1e-4
    for name in ("state", "conv"):
        assert rel_err(gst[name].numpy(), wst[name]) < 1e-4
    assert np.array_equal(tcache["state"].numpy(), cache["state"])   # not written


def test_ssd_decode_chunk_with_mixed_adv_matches_jax():
    """Slot 0 consumes the whole chunk, slot 1 two tokens, slot 2 none:
    the states of slots 1 and 2 advance by exactly those tokens."""
    jcfg, tcfg, jp, tp = ssd_world()
    rng = np.random.RandomState(9)
    Bn, C = 3, 5
    x = rng.randn(Bn, C, jcfg.d_model).astype(np.float32)
    adv = np.array([5, 2, 0], np.int32)
    cache = {"state": rng.randn(Bn, jcfg.ssm_num_heads, jcfg.ssm_state,
                                jcfg.ssm_head_dim).astype(np.float32),
             "conv": rng.randn(Bn, jcfg.conv_kernel - 1,
                               jcfg.ssm_d_inner + 2 * jcfg.ssm_state).astype(np.float32)}
    want, wst = JL.ssd_decode_chunk(jcfg, jp, jnp.asarray(x),
                                    {k: jnp.asarray(v) for k, v in cache.items()},
                                    jnp.asarray(adv))
    got, gst = L.ssd_decode_chunk(tcfg, tp, t(x), {k: t(v) for k, v in cache.items()},
                                  t(adv))
    for b in range(Bn):
        if adv[b]:
            assert rel_err(got.numpy()[b, :adv[b]], np.asarray(want)[b, :adv[b]]) < 1e-4
    for name in ("state", "conv"):
        assert rel_err(gst[name].numpy(), wst[name]) < 1e-4
        assert np.array_equal(gst[name].numpy()[2], cache[name][2])   # idle slot


def test_ssd_prefill_state_matches_stepwise():
    """ssd_apply(return_state) == the state after S sequential decodes,
    the bounds of test_decode.py, on the port alone."""
    _, tcfg, _, tp = ssd_world(chunk=8)
    S = 20
    x = t(np.random.RandomState(10).randn(2, S, tcfg.d_model).astype(np.float32))
    _, st = L.ssd_apply(tcfg, tp, x, return_state=True)
    cache = L.init_ssd_cache(tcfg, 2, torch.device("cpu"))
    for i in range(S):
        _, cache = L.ssd_decode(tcfg, tp, x[:, i:i + 1], cache)
    assert float((st["state"] - cache["state"]).abs().max()) < 1e-3
    assert float((st["conv"] - cache["conv"]).abs().max()) < 1e-4


# ---------------------------------------------------------------------------
# Parameters and the entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_ssd_init_matches_jax(arch):
    """a_log is log(linspace(1, 16, H)) in every layer, as JAX's init under
    vmap gives it (one f32 ulp apart: torch's and XLA's log differ in
    the last bit); dt_bias, a_log and d_skip stay f32 in a bf16 model."""
    cfg = smoke_config(arch)
    assert cfg.param_dtype == "bfloat16"
    tp = lm.init_params(cfg, 0, "cpu")["layers"]["ssd"]
    jp = jax.tree.map(np.asarray, jlm.init_params(
        jax_smoke_config(arch), jax.random.PRNGKey(0))["layers"]["ssd"])
    a = tp["a_log"].numpy()
    assert a.shape == (cfg.num_layers, cfg.ssm_num_heads)
    assert (a == a[0]).all()
    assert np.max(np.abs(a - jp["a_log"])) < 1e-6
    for name in ("dt_bias", "a_log", "d_skip"):
        assert tp[name].dtype == torch.float32 and jp[name].dtype == np.float32
    assert tp["w_in_x"].dtype == torch.bfloat16
    assert not torch.equal(tp["w_in_x"][0], tp["w_in_x"][1])   # layers differ


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
def test_launch_serve_ssm_and_hybrid_smoke_on_cpu(arch):
    from repro_torch.launch import serve
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--new-tokens", "3"])
    assert out["arch"] == arch and out["completed"] == 3 and out["failed"] == 0
    assert out["generated_tokens"] == 9

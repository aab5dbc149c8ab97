"""The port's models, every family, against the JAX package, on the CPU.

First the JAX oracle the port is held against: JAX ``decode_chunk``
over the paged pool must reproduce JAX ``forward``. Then the port's
``forward`` (dense and kernel paths), ``prefill`` and its cache,
``decode_step`` and ``decode_chunk`` (logits, the K/V pool after the
scatter and the SSD state after each chunk) against JAX on the same
converted parameters; for the moe family also ``forward``'s aux losses.

Tolerances: decode vs forward 2e-3 relative, the bound of
``test_decode.py``; port vs JAX 1e-4 relative in f32, which leaves room
only for summation order; the aux losses 1e-5 relative (scalars of f32
means).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import lm

ARCHS = ["yi-34b", "h2o-danube-1.8b", "qwen1.5-110b", "arctic-480b", "grok-1-314b",
         "mamba2-780m", "hymba-1.5b", "internvl2-1b", "musicgen-medium"]
ORACLE_ARCHS = ["yi-34b", "h2o-danube-1.8b", "arctic-480b", "mamba2-780m", "hymba-1.5b",
                "internvl2-1b", "musicgen-medium"]


def f32(cfg):
    return cfg.replace(compute_dtype="float32", param_dtype="float32")


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


_PARAMS = {}


def world(arch):
    """(jax cfg, torch cfg, jax params, torch params) on shared weights.

    Biases, norm scales and the SSD skip are randomized (they init to 0
    and 1), so the qkv, dt and conv biases, the norm scale multiply and
    the D skip are exercised."""
    if arch not in _PARAMS:
        jcfg = f32(jax_smoke_config(arch))
        tcfg = f32(smoke_config(arch))
        tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(7)))
        rng = np.random.RandomState(3)

        def perturb(node, name=""):
            if isinstance(node, dict):
                return {k: perturb(v, k) for k, v in node.items()}
            if name in ("bq", "bk", "bv", "dt_bias", "conv_b"):
                return (rng.randn(*node.shape) * 0.1).astype(node.dtype)
            if name in ("scale", "d_skip"):
                return (1.0 + rng.randn(*node.shape) * 0.1).astype(node.dtype)
            return node

        tree = perturb(tree)
        _PARAMS[arch] = (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
                         convert.params_from_jax(tree, "cpu"))
    return _PARAMS[arch]


def tokens(cfg, B, S, seed=0):
    """(B, S) ids; (B, S, ncb) codes for the audio family."""
    shape = (B, S, cfg.num_codebooks) if cfg.frontend == "audio" else (B, S)
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, shape).astype(np.int32)


# ---------------------------------------------------------------------------
# Paged-chunk schedules shared by the JAX oracle and the port
# ---------------------------------------------------------------------------

B, S_TOTAL, BS, NB_SLOT = 2, 20, 8, 4      # 2 slots, 20 tokens, 4 blocks of 8
SCHEDULES = {
    "chunk1": [[1] * 20, [1] * 20],
    "chunk16": [[16, 4], [16, 4]],
    "mixed": [[7, 13], [1, 1, 1, 1, 16]],
}


def plan(schedule):
    """Per tick: (C, adv (B,), pos (B,))."""
    ticks = max(len(s) for s in schedule)
    pos = np.zeros(B, np.int32)
    out = []
    for t in range(ticks):
        adv = np.array([s[t] if t < len(s) else 0 for s in schedule], np.int32)
        C = 1 if adv.max() <= 1 else 16
        out.append((C, adv, pos.copy()))
        pos = pos + adv
    return out


def block_table():
    # slot b owns physical blocks 1 + b*NB_SLOT ...; block 0 is the sentinel
    return np.arange(1, 1 + B * NB_SLOT, dtype=np.int32).reshape(B, NB_SLOT)


def feed(toks, C, adv, pos):
    f = np.zeros((B, C) + toks.shape[2:], np.int32)
    for b in range(B):
        f[b, :adv[b]] = toks[b, pos[b]:pos[b] + adv[b]]
    return f


_JIT = {}


def jax_chunk(cfg):
    if cfg not in _JIT:
        _JIT[cfg] = jax.jit(lambda p, t, c, bt, pos, adv, zb, rs: jlm.decode_chunk(
            cfg, p, t, c, bt, pos, adv, zero_blocks=zb, reset_slots=rs))
    return _JIT[cfg]


NO_RESET = np.zeros((B,), bool)


# ---------------------------------------------------------------------------
# The JAX oracle: decode_chunk == forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(SCHEDULES))
@pytest.mark.parametrize("arch", ORACLE_ARCHS)
def test_jax_decode_chunk_matches_forward(arch, mode):
    jcfg, _, jp, _ = world(arch)
    assert jcfg.sliding_window == 0 or jcfg.sliding_window < S_TOTAL
    toks = tokens(jcfg, B, S_TOTAL)
    full, _ = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)}, remat="none")
    full = np.asarray(full)
    cache = jlm.init_paged_cache(jcfg, B, 1 + B * NB_SLOT, BS)
    bt = jnp.asarray(block_table())
    zb = jnp.full((B * NB_SLOT,), 1 + B * NB_SLOT, jnp.int32)
    step = jax_chunk(jcfg)
    for C, adv, pos in plan(SCHEDULES[mode]):
        lg, cache = step(jp, jnp.asarray(feed(toks, C, adv, pos)), cache, bt,
                         jnp.asarray(pos), jnp.asarray(adv), zb,
                         jnp.asarray(NO_RESET))
        lg = np.asarray(lg)
        for b in range(B):
            n = adv[b]
            if n:
                got = lg[b, :n]
                want = full[b, pos[b]:pos[b] + n]
                assert rel_err(got, want) < 2e-3, (b, pos[b], rel_err(got, want))


# ---------------------------------------------------------------------------
# Port vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch):
    assert (dataclasses.asdict(smoke_config(arch))
            == dataclasses.asdict(jax_smoke_config(arch)))


@pytest.mark.parametrize("arch", ARCHS + ["phi3-medium-14b"])
def test_param_tree_shapes_match_jax(arch):
    """Shapes and dtypes, full configs included: the SSD's dt_bias,
    a_log and d_skip stay f32 beside bf16 weights."""
    jtree = jlm.abstract_params(jax_smoke_config(arch))
    ttree = lm.abstract_params(smoke_config(arch))
    jflat = {jax.tree_util.keystr(k): v for k, v in
             jax.tree_util.tree_flatten_with_path(jtree)[0]}

    def flat(node, prefix=""):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                out.update(flat(v, f"{prefix}['{k}']"))
            return out
        return {prefix: node}

    tflat = flat(ttree)
    assert sorted(tflat) == sorted(jflat)
    for k, t in tflat.items():
        assert tuple(t.shape) == tuple(jflat[k].shape), k
        assert str(t.dtype).split(".")[-1] == str(jflat[k].dtype), k


def test_init_params_makes_the_tree_on_the_device():
    cfg = smoke_config("h2o-danube-1.8b")
    p = lm.init_params(cfg, 0, "cpu")
    q = lm.init_params(cfg, 0, "cpu")
    assert p["layers"]["attn"]["wq"].shape == (cfg.num_layers, cfg.d_model,
                                               cfg.num_heads, cfg.resolved_head_dim)
    assert p["embed"].dtype == torch.bfloat16 and p["embed"].device.type == "cpu"
    assert torch.equal(p["layers"]["mlp"]["w_up"], q["layers"]["mlp"]["w_up"])
    assert torch.equal(p["final_norm"]["scale"], torch.ones(cfg.d_model,
                                                            dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_is_bit_exact(dtype):
    cfg = jax_smoke_config("yi-34b").replace(param_dtype=dtype)
    tree = jax.tree.map(np.asarray, jlm.init_params(cfg, jax.random.PRNGKey(0)))
    tp = convert.params_from_jax(tree, "cpu")
    w = tree["layers"]["attn"]["wq"]
    t = tp["layers"]["attn"]["wq"]
    assert str(t.dtype) == f"torch.{dtype}" and tuple(t.shape) == w.shape
    if dtype == "bfloat16":
        assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                              w.view(np.uint16))
    else:
        assert np.array_equal(t.numpy(), w)
    t.add_(1)          # writable copy: the numpy source is untouched
    assert np.array_equal(np.asarray(tree["layers"]["attn"]["wq"]), w)


@pytest.mark.parametrize("impl", ["dense", "kernel"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, impl):
    jcfg, tcfg, jp, tp = world(arch)
    toks = tokens(jcfg, 2, 20, seed=1)
    want, want_aux = jlm.forward(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                 attention_impl=impl, remat="none")
    got, aux = lm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                          attention_impl=impl)
    assert rel_err(got.numpy(), want) < 1e-4
    assert sorted(aux) == sorted(want_aux)
    for name, v in aux.items():
        assert v.dtype == torch.float32 and v.shape == ()
        assert abs(float(v) - float(want_aux[name])) <= 1e-5 * abs(float(want_aux[name]))


def test_blockwise_attention_matches_dense():
    from repro_torch.models import layers as L
    cfg = f32(smoke_config("h2o-danube-1.8b"))
    rng = np.random.RandomState(0)
    Bq, S, H, K, hd = 2, 50, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = torch.from_numpy(rng.randn(Bq, S, H, hd).astype(np.float32))
    k = torch.from_numpy(rng.randn(Bq, S, K, hd).astype(np.float32))
    v = torch.from_numpy(rng.randn(Bq, S, K, hd).astype(np.float32))
    pos = torch.arange(S)
    old = (L.Q_BLOCK, L.KV_BLOCK)
    try:
        L.Q_BLOCK, L.KV_BLOCK = 16, 16
        dense = L._attend_dense(cfg, q, k, v, pos, pos)
        block = L._attend_blockwise(cfg, q, k, v, pos, pos)
    finally:
        L.Q_BLOCK, L.KV_BLOCK = old
    assert float((dense - block).abs().max()) < 1e-4


@pytest.mark.parametrize("act", ["geglu", "gelu"])
def test_mlp_activations_match_jax(act):
    from repro.models import layers as JL
    from repro.models.modules import Builder as JBuilder, Mode as JMode
    from repro_torch.models import layers as L
    jcfg = f32(jax_smoke_config("yi-34b")).replace(act=act)
    tcfg = f32(smoke_config("yi-34b")).replace(act=act)
    jp = JL.build_mlp(JBuilder(JMode.INIT, jax.random.PRNGKey(0), jnp.float32), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.RandomState(1).randn(2, 5, jcfg.d_model).astype(np.float32)
    want = JL.mlp_apply(jcfg, jp, jnp.asarray(x))
    got = L.mlp_apply(tcfg, tp, torch.from_numpy(x))
    assert rel_err(got.numpy(), want) < 1e-5


def test_cross_entropy_matches_jax():
    cfg = f32(smoke_config("yi-34b"))
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 6, cfg.vocab_size).astype(np.float32)
    labels = rng.randint(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    w = (rng.rand(2, 6) > 0.3).astype(np.float32)
    for weights in (None, w):
        want = jlm.cross_entropy(cfg, jnp.asarray(logits), jnp.asarray(labels),
                                 None if weights is None else jnp.asarray(weights))
        got = lm.cross_entropy(cfg, torch.from_numpy(logits), torch.from_numpy(labels),
                               None if weights is None else torch.from_numpy(weights))
        assert abs(float(got) - float(want)) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_cache_match_jax(arch):
    """S > the smoke window (16), so danube's ring buffer is rolled."""
    jcfg, tcfg, jp, tp = world(arch)
    toks = tokens(jcfg, 2, 21, seed=2)
    want, jcache = jlm.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_len=28)
    got, tcache = lm.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, max_len=28)
    assert rel_err(got.numpy(), want) < 1e-4
    assert np.array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    assert sorted(tcache) == sorted(jcache)
    for name in ("k", "v") if "kv" in jcache else ():
        assert tcache["kv"][name].shape == jcache["kv"][name].shape
        assert rel_err(tcache["kv"][name].numpy(), jcache["kv"][name]) < 1e-5
    for name in ("state", "conv") if "ssd" in jcache else ():
        t = tcache["ssd"][name]
        assert t.shape == jcache["ssd"][name].shape
        assert str(t.dtype).split(".")[-1] == str(jcache["ssd"][name].dtype)
        assert rel_err(t.numpy(), jcache["ssd"][name]) < 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(arch):
    jcfg, tcfg, jp, tp = world(arch)
    toks = tokens(jcfg, 2, 20, seed=3)
    jc = jlm.init_cache(jcfg, 2, 20)
    tc = lm.init_cache(tcfg, 2, 20, "cpu")
    jstep = jax.jit(lambda p, t, c: jlm.decode_step(jcfg, p, t, c))
    for t in range(20):
        jl, jc = jstep(jp, jnp.asarray(toks[:, t:t + 1]), jc)
        tl, tc = lm.decode_step(tcfg, tp, torch.from_numpy(toks[:, t:t + 1]), tc)
        assert rel_err(tl.numpy(), jl) < 1e-4, t
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    if "kv" in jc:
        assert rel_err(tc["kv"]["k"].numpy(), jc["kv"]["k"]) < 1e-5
    for name in ("state", "conv") if "ssd" in jc else ():
        assert rel_err(tc["ssd"][name].numpy(), jc["ssd"][name]) < 1e-4


@pytest.mark.parametrize("mode", ["chunk1", "mixed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_chunk_matches_jax(arch, mode):
    """Logits per tick, the whole K/V pool after each scatter and the SSD
    state after each chunk: padded rows (j >= adv) must not be written
    or advance a recurrence, the sentinel block 0 stays zero,
    zero_blocks (padded with NB) zeroes exactly its real entries, and
    reset_slots zeroes exactly its slots' SSD state."""
    jcfg, tcfg, jp, tp = world(arch)
    toks = tokens(jcfg, B, S_TOTAL, seed=4)
    NB = 2 + B * NB_SLOT                  # one spare block past the tables
    jcache = jlm.init_paged_cache(jcfg, B, NB, BS)
    tcache = lm.init_paged_cache(tcfg, B, NB, BS, "cpu")
    assert sorted(tcache) == sorted(jcache)
    has_kv = "kv" in jcache
    if has_kv:
        junk = np.random.RandomState(5).randn(*jcache["kv"]["k"][:, NB - 1].shape
                                              ).astype(np.float32)
        jcache = {**jcache,
                  "kv": {n: a.at[:, NB - 1].set(junk) for n, a in jcache["kv"].items()}}
        for a in tcache["kv"].values():
            a[:, NB - 1] = torch.from_numpy(junk)
    bt = block_table()
    step = jax_chunk(jcfg)
    for t, (C, adv, pos) in enumerate(plan(SCHEDULES[mode])):
        zb = np.full((B * NB_SLOT,), NB, np.int32)
        rs = NO_RESET.copy()
        if t == 1:
            zb[0] = NB - 1                # zero the spare block this tick
        if t == 2:
            rs[0] = True                  # reset slot 0's SSD state this tick
        f = feed(toks, C, adv, pos)
        jl, jcache = step(jp, jnp.asarray(f), jcache, jnp.asarray(bt),
                          jnp.asarray(pos), jnp.asarray(adv), jnp.asarray(zb),
                          jnp.asarray(rs))
        tl, tcache = lm.decode_chunk(
            tcfg, tp, torch.from_numpy(f), tcache, torch.from_numpy(bt),
            torch.from_numpy(pos), torch.from_numpy(adv),
            zero_blocks=torch.from_numpy(zb), reset_slots=torch.from_numpy(rs))
        live = [(b, j) for b in range(B) for j in range(adv[b])]
        got = np.stack([tl.numpy()[b, j] for b, j in live])
        want = np.stack([np.asarray(jl)[b, j] for b, j in live])
        assert rel_err(got, want) < 1e-4, t
        for n in ("state", "conv") if "ssd" in jcache else ():
            ts, js = tcache["ssd"][n].numpy(), np.asarray(jcache["ssd"][n])
            assert np.max(np.abs(ts - js)) <= 1e-4 * max(np.max(np.abs(js)), 1.0), (t, n)
        for n in ("k", "v") if has_kv else ():
            tk, jk = tcache["kv"][n].numpy(), np.asarray(jcache["kv"][n])
            assert np.max(np.abs(tk - jk)) <= 1e-5 * max(np.max(np.abs(jk)), 1.0), (t, n)
            assert not tk[:, 0].any()                        # sentinel stays zero
            if t >= 1:
                assert not tk[:, NB - 1].any()               # zero-epoched
            else:
                assert tk[:, NB - 1].any()
    if not has_kv:
        return
    # every slot's K rows past its clock are still zero: nothing padded was written
    for b in range(B):
        flat = tcache["kv"]["k"].numpy()[:, bt[b]].reshape(tcfg.num_layers, -1,
                                                           tcfg.num_kv_heads,
                                                           tcfg.resolved_head_dim)
        assert not flat[:, S_TOTAL:].any()


def test_decode_chunk_reset_zeroes_only_its_slots():
    """reset_slots zeroes the chosen slots' SSD state and conv window in
    place before the chunk runs; an idle slot (adv 0) keeps its state."""
    _, tcfg, _, tp = world("mamba2-780m")
    cache = lm.init_paged_cache(tcfg, 3, 1, BS, "cpu")
    rng = np.random.RandomState(6)
    for a in cache["ssd"].values():
        a.copy_(torch.from_numpy(rng.randn(*a.shape).astype(np.float32)))
    before = {n: a.clone() for n, a in cache["ssd"].items()}
    adv = torch.tensor([0, 0, 0], dtype=torch.int32)
    lm.decode_chunk(tcfg, tp, torch.zeros((3, 1), dtype=torch.int32), cache,
                    torch.zeros((3, 1), dtype=torch.int32),
                    torch.zeros(3, dtype=torch.int32), adv,
                    reset_slots=torch.tensor([False, True, False]))
    for n, a in cache["ssd"].items():
        assert not a[:, 1].any()
        assert torch.equal(a[:, 0], before[n][:, 0])
        assert torch.equal(a[:, 2], before[n][:, 2])


def test_paged_cache_layers_are_separate_tensors():
    """The stacked SSD cache holds real zeros per layer: writing one
    layer leaves the others (JAX's broadcast_to views would alias)."""
    _, tcfg, _, _ = world("hymba-1.5b")
    cache = lm.init_paged_cache(tcfg, 2, 3, BS, "cpu")
    cache["ssd"]["state"][0].fill_(1.0)
    assert not cache["ssd"]["state"][1:].any()
    assert cache["ssd"]["state"].dtype == torch.float32
    assert cache["ssd"]["conv"].shape == (
        tcfg.num_layers, 2, tcfg.conv_kernel - 1, tcfg.ssm_d_inner + 2 * tcfg.ssm_state)


def test_unknown_arch_raises_key_error():
    """Every arch of the JAX registry is ported; a name outside it fails
    loudly, in both registries alike."""
    from repro.configs.registry import get_config as jax_get_config
    from repro_torch.configs.registry import ARCHS as PORT_ARCHS, get_config
    from repro.configs.registry import ARCHS as JAX_ARCHS
    assert sorted(PORT_ARCHS) == sorted(JAX_ARCHS)
    for lookup in (get_config, jax_get_config):
        with pytest.raises(KeyError, match="unknown arch"):
            lookup("llama-9000")

"""The port's training step against the JAX package's, on the CPU.

Schedules, AdamW and Adafactor (factored and unfactored leaves), global
norm clipping, ``lm.train_loss``'s gradients for one smoke config of
every family, the whole step after one and two AdamW steps, microbatch
accumulation, the remat modes, the ``grad_transform`` hook and the
synthetic data pipeline. Then the kernel wrappers' autograd paths, run
here with stand-in kernels that write their output outside autograd as
the CUDA kernels do, under every remat mode, with their launches.

Tolerances: schedules 1e-6 relative; optimizer updates 1e-6 relative
per leaf (the same f32 formula, elementwise); gradients 1e-4 of each
leaf's largest magnitude (f32 sums in another order through a whole
model); after one and two AdamW steps at lr 1e-3 the parameters 5e-5
absolute, the bound of the JAX package's own microbatch test
(``tests/test_train_infra.py``), and loss and grad norm 1e-4 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.data.pipeline import SyntheticLMData as JaxSyntheticLMData
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import schedule as jsched
from repro.train.train_step import StepConfig as JaxStepConfig
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
from repro_torch.models import layers, lm
from repro_torch.train import optimizer as topt
from repro_torch.train import schedule as tsched
from repro_torch.train.train_step import StepConfig, make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten

FAMILY_ARCHS = ["yi-34b", "arctic-480b", "mamba2-780m", "hymba-1.5b",
                "internvl2-1b", "musicgen-medium"]


def f32(cfg):
    return cfg.replace(compute_dtype="float32", param_dtype="float32")


def to_torch(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def leaf_pairs(ttree, jtree):
    """(port leaf as numpy, JAX leaf as numpy) in one leaf order; the
    port's side may be a tree or its list of leaves."""
    tl = ttree if isinstance(ttree, list) else tree_leaves(ttree)
    jl = jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    return [(t.detach().float().numpy(), np.asarray(j, np.float32)) for t, j in zip(tl, jl)]


def batch_of(cfg, B, S, seed=0, weights=False):
    """A seeded numpy batch for ``cfg``: tokens (codes for audio), labels,
    patch embeddings for vision; optional 0/1 loss weights."""
    rng = np.random.RandomState(seed)
    shape = (B, S, cfg.num_codebooks) if cfg.frontend == "audio" else (B, S)
    toks = rng.randint(0, cfg.vocab_size, shape).astype(np.int32)
    out = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.frontend == "vision":
        out["patch_embeds"] = rng.randn(B, cfg.num_patches, cfg.vit_dim).astype(np.float32)
    if weights:
        out["weights"] = (rng.rand(B, S) > 0.3).astype(np.float32)
    return out


def jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


_WORLDS = {}


def world(arch):
    """(jax cfg, torch cfg, jax params, torch params), f32, shared weights."""
    if arch not in _WORLDS:
        jcfg = f32(jax_smoke_config(arch))
        jp = jlm.init_params(jcfg, jax.random.PRNGKey(11))
        _WORLDS[arch] = (jcfg, f32(smoke_config(arch)), jp, to_torch(jp))
    return _WORLDS[arch]


def port_grads(cfg, params, batch, remat="none", attention_impl="auto"):
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, metrics = lm.train_loss(cfg, tree_unflatten(params, live), torch_batch(batch),
                                  attention_impl, remat)
    grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
    return loss.detach(), list(grads), metrics


# ---------------------------------------------------------------------------
# Schedules, optimizers, clipping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["constant", "cosine"])
def test_schedules_match_jax(which):
    if which == "constant":
        jf, tf = jsched.constant_schedule(3e-4), tsched.constant_schedule(3e-4)
    else:
        jf = jsched.cosine_schedule(1e-3, 3, 11, final_frac=0.05)
        tf = tsched.cosine_schedule(1e-3, 3, 11, final_frac=0.05)
    for step in range(14):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        got = tf(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= 1e-6 * abs(want) + 1e-12, (step, float(got), want)


def opt_tree(rng, dtype):
    """Leaves of every kind an optimizer treats apart: factored matrices
    (both last dims >= 128, one stacked), unfactored matrices and a
    vector (no decay)."""
    def a(*shape):
        return jnp.asarray(rng.randn(*shape).astype(np.float32) * 0.05).astype(dtype)
    return {"w_big": a(130, 144), "layers": {"w_stack": a(2, 128, 136), "w_small": a(2, 16, 24),
                                             "scale": a(24)}, "w_tall": a(200, 64)}


OPTIMIZERS = {
    "adamw": lambda m: m.AdamW(m_sched(m).constant_schedule(1e-3)),
    "adamw_cosine": lambda m: m.AdamW(m_sched(m).cosine_schedule(2e-3, 1, 3), b2=0.99,
                                      weight_decay=0.05),
    "adafactor": lambda m: m.Adafactor(m_sched(m).constant_schedule(1e-2)),
    # min_dim_size_to_factor lowered: the smoke-width leaves factor too,
    # with decay on the matrices
    "adafactor_factor16": lambda m: m.Adafactor(m_sched(m).constant_schedule(1e-2),
                                                min_dim_size_to_factor=16,
                                                weight_decay=0.01),
}


def m_sched(m):
    return jsched if m is jopt else tsched


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name, dtype):
    """Three updates from identical params, grads and state (JAX's,
    converted): params and state within 1e-6 relative per leaf."""
    rng = np.random.RandomState(5)
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    jp = opt_tree(rng, jnp.dtype(dtype))
    js = jo.init(jp)
    tp, ts = to_torch(jp), to_torch(js)
    assert jax.tree.structure(jax.tree.map(np.asarray, js)) == jax.tree.structure(
        jax.tree.map(lambda t: t.numpy(), ts))
    if name.startswith("adafactor"):
        factored = [k for k, v in ts["acc"]["layers"].items() if "vr" in v]
        assert "w_stack" in factored and "vr" in ts["acc"]["w_big"]
        assert ("w_small" in factored) == (name == "adafactor_factor16")
    for t in range(3):
        jg = opt_tree(rng, jnp.dtype(dtype))
        jp, js = jo.update(jp, jg, js, jnp.asarray(t, jnp.int32))
        tp, ts = to.update(tp, to_torch(jg), ts, torch.tensor(t, dtype=torch.int32))
        for got, want in leaf_pairs(ts, js):
            assert rel_err(got, want) <= 1e-6, (t, rel_err(got, want))
        for got, want in leaf_pairs(tp, jp):
            if dtype == "float32":
                assert rel_err(got, want) <= 1e-6, (t, rel_err(got, want))
            else:
                # the same f32 update, cast to bf16: where it lies within
                # an f32 ulp of a bf16 rounding boundary the cast may go
                # either way, by one bf16 step (at most 2^-7 of the element)
                assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want)), t
                assert np.sum(got != want) <= max(2, 1e-3 * got.size), t
    for got, want in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.RandomState(6)
    jt = {"a": jnp.asarray(rng.randn(5, 7).astype(np.float32)),
          "b": {"c": jnp.asarray(rng.randn(9).astype(np.float32)).astype(jnp.bfloat16)}}
    jclip, jnorm = jopt.clip_by_global_norm(jt, max_norm)
    tclip, tnorm = topt.clip_by_global_norm(to_torch(jt), max_norm)
    assert rel_err(float(tnorm), float(jnorm)) <= 1e-6
    assert tclip["b"]["c"].dtype == torch.bfloat16
    for got, want in leaf_pairs(tclip, jclip):
        assert rel_err(got, want) <= 1e-6
    assert float(topt.global_norm(tclip)) <= max_norm * (1 + 1e-2)


# ---------------------------------------------------------------------------
# train_loss gradients, the whole step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_loss_grads_match_jax(arch):
    jcfg, tcfg, jp, tp = world(arch)
    b = batch_of(jcfg, 2, 16, seed=1, weights=True)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jlm.train_loss(jcfg, p, jax_batch(b), remat="none"), has_aux=True)(jp)
    loss, grads, metrics = port_grads(tcfg, tp, b)
    assert rel_err(float(loss), float(jl)) <= 1e-5
    assert sorted(metrics) == sorted(jm)
    for (got, want), name in zip(leaf_pairs(grads, jg),
                                 [jax.tree_util.keystr(k) for k, _ in
                                  jax.tree_util.tree_flatten_with_path(jg)[0]]):
        scale = float(np.max(np.abs(want)))
        assert np.max(np.abs(got - want)) <= 1e-4 * scale, (name, scale)
    if tcfg.frontend == "vision":   # the projector is reached through the image prefix
        assert np.abs(grads[tree_leaves_index(tp, "proj_in")].numpy()).max() > 0


def tree_leaves_index(params, key):
    """Index of ``params[key]`` among the tree's leaves."""
    return [i for i, t in enumerate(tree_leaves(params)) if t is params[key]][0]


@pytest.fixture(scope="module")
def step_world():
    """smoke yi-34b in f32, AdamW at lr 1e-3, one batch of 8 x 16."""
    jcfg, tcfg, jp, tp = world("yi-34b")
    b = JaxSyntheticLMData(jcfg, 8, 16).batch(0)
    jo, to = jopt.AdamW(jsched.constant_schedule(1e-3)), topt.AdamW(
        tsched.constant_schedule(1e-3))
    js0 = {"params": jp, "opt_state": jo.init(jp), "step": jnp.zeros((), jnp.int32)}
    ts0 = {"params": tp, "opt_state": to.init(tp), "step": torch.zeros((), dtype=torch.int32)}
    return jcfg, tcfg, jo, to, js0, ts0, b


def grad_signal(jcfg, params, batch):
    """Per leaf, each element's |gradient| over the leaf's largest (JAX)."""
    g = jax.grad(lambda p: jlm.train_loss(jcfg, p, jax_batch(batch), remat="none")[0])(params)
    return [np.abs(np.asarray(x)) / max(float(np.abs(x).max()), 1e-30)
            for x in jax.tree.leaves(g)]


def assert_adamw_params_close(tparams, jparams, signal, steps):
    """AdamW moves an element by lr * m / (sqrt(v) + eps): where the
    gradient is at the level of f32 summation noise (~1e-8 against a
    leaf's largest 2e-2 here, in gradients held to 1e-4 of that largest),
    a noise-sized difference of g moves the parameter by up to lr (lr
    1e-3 here). So 5e-5 holds every element whose gradient was above 1e-5
    of its leaf's largest in every step so far (``signal``: the least over
    the steps); the others, at noise level, are held to the 2 * lr per
    step an update can move them by, and must be few."""
    misses = 0
    for (got, want), sig in zip(leaf_pairs(tparams, jparams), signal):
        err = np.abs(got - want)
        assert np.max(err[sig > 1e-5], initial=0.0) <= 5e-5
        assert np.max(err, initial=0.0) <= 2 * 1e-3 * steps
        misses += int(np.sum(err > 5e-5))
    assert misses <= 4, misses


def test_train_step_matches_jax(step_world):
    """Params after 1 and 2 steps within 5e-5 abs
    (:func:`assert_adamw_params_close`); loss and grad norm within 1e-4
    rel."""
    jcfg, tcfg, jo, to, js, ts, b = step_world
    jstep = jax.jit(jax_make_train_step(jcfg, jo, JaxStepConfig(remat="none")))
    tstep = make_train_step(tcfg, to, StepConfig())
    signal = None
    for t in range(2):
        g = grad_signal(jcfg, js["params"], b)
        signal = g if signal is None else [np.minimum(a, c) for a, c in zip(signal, g)]
        js, jm = jstep(js, jax_batch(b))
        ts, tm = tstep(ts, torch_batch(b))
        assert int(ts["step"]) == int(js["step"]) == t + 1
        assert sorted(tm) == sorted(jm)
        for k in ("loss", "grad_norm"):
            assert rel_err(float(tm[k]), float(jm[k])) <= 1e-4, (t, k)
        assert_adamw_params_close(ts["params"], js["params"], signal, t + 1)


def test_microbatches_match_one_batch(step_world):
    """4 contiguous microbatches, grads summed in f32 and divided by 4,
    give the one-batch step within 5e-5 (the JAX test's bound)."""
    _, tcfg, _, to, _, ts, b = step_world
    s1, m1 = make_train_step(tcfg, to, StepConfig(microbatches=1))(ts, torch_batch(b))
    s4, m4 = make_train_step(tcfg, to, StepConfig(microbatches=4))(ts, torch_batch(b))
    err = max(float((a - c).abs().max()) for a, c in
              zip(tree_leaves(s1["params"]), tree_leaves(s4["params"])))
    assert err < 5e-5, err
    assert abs(float(m1["loss"]) - float(m4["loss"])) <= 1e-5 * float(m1["loss"])


def test_microbatch_step_matches_jax(step_world):
    jcfg, tcfg, jo, to, js, ts, b = step_world
    signal = grad_signal(jcfg, js["params"], b)
    js, jm = jax.jit(jax_make_train_step(jcfg, jo, JaxStepConfig(microbatches=2,
                                                                 remat="none")))(
        js, jax_batch(b))
    ts, tm = make_train_step(tcfg, to, StepConfig(microbatches=2))(ts, torch_batch(b))
    assert rel_err(float(tm["grad_norm"]), float(jm["grad_norm"])) <= 1e-4
    assert_adamw_params_close(ts["params"], js["params"], signal, 1)


def test_grad_transform_runs_before_clipping(step_world):
    """The hook sees the microbatch mean, and the clip and the reported
    norm see what it returns."""
    _, tcfg, _, to, _, ts, b = step_world
    seen = []

    def triple(grads):
        seen.append(grads)
        return _scale(grads, 3.0)

    _, plain = make_train_step(tcfg, to, StepConfig(microbatches=2, clip_norm=1e9))(
        ts, torch_batch(b))
    _, hooked = make_train_step(tcfg, to, StepConfig(microbatches=2, clip_norm=1e9),
                                grad_transform=triple)(ts, torch_batch(b))
    assert len(seen) == 1
    assert abs(float(hooked["grad_norm"]) - 3 * float(plain["grad_norm"])) <= (
        1e-5 * float(hooked["grad_norm"]))
    assert abs(float(topt.global_norm(seen[0])) - float(plain["grad_norm"])) <= (
        1e-5 * float(plain["grad_norm"]))


def _scale(tree, k):
    if isinstance(tree, dict):
        return {n: _scale(v, k) for n, v in tree.items()}
    return tree * k


@pytest.mark.parametrize("arch", ["yi-34b", "arctic-480b", "hymba-1.5b", "internvl2-1b"])
def test_remat_modes_give_equal_grads(arch):
    _, tcfg, _, tp = world(arch)
    b = batch_of(tcfg, 2, 16, seed=2)
    _, base, _ = port_grads(tcfg, tp, b, remat="none")
    for remat in ("dots", "full"):
        _, grads, _ = port_grads(tcfg, tp, b, remat=remat)
        for g0, g in zip(base, grads):
            assert torch.equal(g0, g), remat


def test_unknown_remat_raises():
    _, tcfg, _, tp = world("yi-34b")
    with pytest.raises(ValueError, match="remat"):
        port_grads(tcfg, tp, batch_of(tcfg, 1, 4), remat="everything")


@pytest.mark.parametrize("arch", ["yi-34b", "internvl2-1b", "musicgen-medium"])
def test_synthetic_data_matches_jax(arch):
    """Text, vision (patch embeddings) and audio (codebook streams):
    bit-equal batches, per step and per shard."""
    cfg = jax_smoke_config(arch)
    jd = JaxSyntheticLMData(cfg, 4, 24, seed=3)
    td = SyntheticLMData(smoke_config(arch), 4, 24, seed=3)
    for step in (0, 5):
        for shard, shards in ((0, 1), (1, 2)):
            want = jd.batch(step, shard, shards)
            got = td.batch(step, shard, shards)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])
    assert ("patch_embeds" in td.batch(0)) == (cfg.frontend == "vision")


# ---------------------------------------------------------------------------
# The kernel wrappers' autograd paths, with stand-in kernels
# ---------------------------------------------------------------------------

def _written_outside_autograd(out: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Write ``value`` into ``out`` through numpy, where neither autograd
    nor a dispatch mode sees it, as a ctypes kernel writes its output."""
    out.detach().numpy()[...] = value.detach().numpy()
    return out


def fake_rmsnorm_fwd(x, scale, eps):
    with torch.no_grad():
        return _written_outside_autograd(torch.empty_like(x), rmsnorm_ref(x, scale, eps))


def fake_ssd_chunk_fwd(C, B, x, dt, da):
    with torch.no_grad():
        ref = ssd_chunk_ref(C, B, x, dt, da)
    return tuple(_written_outside_autograd(torch.empty_like(r), r) for r in ref)


def fake_flash_forward(q, k, v, causal, window):
    flash_ops.launches += 1
    with torch.no_grad():
        ref = attention_ref(q, k, v, causal=causal, window=window)
    return _written_outside_autograd(torch.empty_like(ref), ref)


def card_rmsnorm(x, scale, eps=1e-6):
    """The CUDA branch of ``rmsnorm_ops.rmsnorm``, taken on the CPU."""
    if (x.requires_grad or scale.requires_grad) and torch.is_grad_enabled():
        return rmsnorm_ops._RMSNorm.apply(x, scale, eps)
    return rmsnorm_ops._launch(x, scale, eps)


def card_ssd_chunk(C, B, x, dt, da):
    """The CUDA branch of ``ssd_ops.ssd_chunk``, taken on the CPU."""
    if any(t.requires_grad for t in (C, B, x, dt, da)) and torch.is_grad_enabled():
        return ssd_ops._SSDChunk.apply(C, B, x, dt, da)
    return ssd_ops._launch(C, B, x, dt, da)


@pytest.fixture
def stand_in_kernels(monkeypatch):
    """The model's three kernel calls go through the wrappers' card
    branches, with kernels that write their outputs outside autograd."""
    monkeypatch.setattr(rmsnorm_ops, "rmsnorm_fwd", fake_rmsnorm_fwd)
    monkeypatch.setattr(ssd_ops, "ssd_chunk_fwd", fake_ssd_chunk_fwd)
    monkeypatch.setattr(flash_ops, "_forward", fake_flash_forward)
    monkeypatch.setattr(layers, "rmsnorm_op", card_rmsnorm)
    monkeypatch.setattr(layers, "ssd_chunk", card_ssd_chunk)
    for mod in (rmsnorm_ops, ssd_ops, flash_ops):
        monkeypatch.setattr(mod, "launches", 0)


def counts():
    return {"flash_attention": flash_ops.launches, "rmsnorm": rmsnorm_ops.launches,
            "ssd_chunk": ssd_ops.launches}


def test_autograd_wrappers_carry_the_plain_gradients(stand_in_kernels):
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(3, 5, 24).astype(np.float32)).requires_grad_(True)
    s = torch.from_numpy(1 + 0.1 * rng.randn(24).astype(np.float32)).requires_grad_(True)
    g = torch.from_numpy(rng.randn(3, 5, 24).astype(np.float32))
    y = card_rmsnorm(x, s)
    assert y.grad_fn is not None and rmsnorm_ops.launches == 1
    want = torch.autograd.grad(rmsnorm_ref(x, s), (x, s), g)
    got = torch.autograd.grad(y, (x, s), g)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)
    with torch.no_grad():            # serving: the light launch, no graph
        assert card_rmsnorm(x, s).grad_fn is None
    assert card_rmsnorm(x.detach(), s.detach()).grad_fn is None
    assert rmsnorm_ops.launches == 3

    b_, nc, Q, N, H, P = 1, 2, 8, 4, 3, 4
    ins = [torch.from_numpy(a.astype(np.float32)).requires_grad_(True) for a in (
        rng.randn(b_, nc, Q, N), rng.randn(b_, nc, Q, N), rng.randn(b_, nc, Q, H, P),
        np.log1p(np.exp(rng.randn(b_, nc, Q, H))), -0.1 * np.abs(rng.randn(b_, nc, Q, H)))]
    gs = [torch.from_numpy(rng.randn(*shape).astype(np.float32)) for shape in (
        (b_, nc, Q, H, P), (b_, nc, H, N, P), (b_, nc, H))]
    out = card_ssd_chunk(*ins)
    assert all(o.grad_fn is not None for o in out) and ssd_ops.launches == 1
    want = torch.autograd.grad(ssd_chunk_ref(*ins), ins, gs)
    got = torch.autograd.grad(out, ins, gs)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "internvl2-1b"])
def test_remat_recomputes_the_kernels(stand_in_kernels, arch):
    """Under every remat mode the stand-in kernels' gradients equal the
    plain path's; ``full`` and ``dots`` launch every kernel of a layer
    body twice (forward, and again in the backward's recompute, which
    must rerun a kernel whose output no policy can keep), and the final
    norm once."""
    _, tcfg, _, tp = world(arch)
    b = batch_of(tcfg, 2, 16, seed=4)
    with pytest.MonkeyPatch.context() as mp:      # the plain path, no stand-ins
        mp.setattr(layers, "rmsnorm_op", rmsnorm_ops.rmsnorm)
        mp.setattr(layers, "ssd_chunk", ssd_ops.ssd_chunk)
        mp.setattr(flash_ops, "_forward", lambda q, k, v, c, w: attention_ref(
            q, k, v, causal=c, window=w))
        _, want, _ = port_grads(tcfg, tp, b, attention_impl="kernel")
    L = tcfg.num_layers
    per_body = {"flash_attention": 1, "rmsnorm": 3 if tcfg.hybrid else 2,
                "ssd_chunk": 1 if tcfg.hybrid else 0}
    for remat, passes in (("none", 1), ("dots", 2), ("full", 2)):
        for mod in (rmsnorm_ops, ssd_ops, flash_ops):
            mod.launches = 0
        _, grads, _ = port_grads(tcfg, tp, b, remat=remat, attention_impl="kernel")
        for g, w in zip(grads, want):
            assert torch.allclose(g, w, rtol=0, atol=1e-6 * max(float(w.abs().max()), 1.0)), remat
        expect = {k: passes * L * n for k, n in per_body.items()}
        expect["rmsnorm"] += 1
        assert counts() == expect, remat

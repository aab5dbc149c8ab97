"""The port's MoE block and its serving against the JAX package, on the CPU.

* ``moe_apply`` on converted weights with a skewed router that makes
  the capacity drop choices: the output, the aux losses, the chosen
  experts and the dropped choices equal JAX's;
* the top-k order on tied probabilities equals ``lax.top_k``'s;
* the capacity formula at several token counts;
* the ``ServeEngine``'s greedy tokens equal the JAX engine's for the MoE
  smoke configs, alone and with staggered joins; the launcher serves
  them;
* the ``Builder``'s in-place stacked init gives the bits of the
  list-and-``torch.stack`` init it replaced, for every smoke config.

Tolerances: 1e-4 relative for outputs in f32, as the model tests; 1e-5
relative for the aux losses.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp
from jax import lax

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro.models import lm as jlm
from repro.models.modules import Builder as JBuilder, Mode as JMode
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs.registry import ARCHS as TORCH_ARCHS
from repro_torch.configs.registry import smoke_config
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models import layers as L
from repro_torch.models import lm, modules
from repro_torch.serve.engine import ServeEngine

MOE_ARCHS = ["arctic-480b", "grok-1-314b"]


def f32(cfg):
    return cfg.replace(compute_dtype="float32", param_dtype="float32")


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def jax_keep(ids: np.ndarray, E: int, cap: int) -> np.ndarray:
    """JAX's kept choices from its ids: the exclusive cumsum of the
    one-hot over the flattened (token, choice) order, as ``moe_apply``."""
    flat = ids.reshape(-1)
    onehot = np.eye(E, dtype=np.int64)[flat]
    slots = np.cumsum(onehot, axis=0) - onehot
    return slots[np.arange(flat.size), flat] < cap


# ---------------------------------------------------------------------------
# moe_apply with drops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_with_drops_matches_jax(arch):
    """T = 512 rows, E = 4, k = 2: cap = 384. Every row's mean is
    positive and the router's column 0 adds 0.1 per unit of a row's sum,
    so expert 0 is among every token's two choices: 512 choices for 384
    slots, and the last 128 are dropped."""
    jcfg, tcfg = f32(jax_smoke_config(arch)), f32(smoke_config(arch))
    jp = JL.build_moe(JBuilder(JMode.INIT, jax.random.PRNGKey(3), jnp.float32), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    tree["router"] = tree["router"].copy()
    tree["router"][:, 0] += 0.1
    jp = jax.tree.map(jnp.asarray, tree)
    tp = convert.params_from_jax(tree, "cpu")
    x = (np.random.RandomState(4).randn(2, 256, jcfg.d_model) + 1.0).astype(np.float32)

    want, want_aux = JL.moe_apply(jcfg, jp, jnp.asarray(x))
    got, aux = L.moe_apply(tcfg, tp, torch.from_numpy(x))
    assert rel_err(got.numpy(), want) < 1e-4
    for name in ("load_balance", "router_z"):
        assert abs(float(aux[name]) - float(want_aux[name])) <= 1e-5 * abs(float(want_aux[name]))

    xt = x.reshape(-1, jcfg.d_model)
    r = L._route(tcfg, tp, torch.from_numpy(xt))
    assert r.cap == 384
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jp["router"], axis=-1)
    jw, jids = lax.top_k(jprobs, jcfg.top_k)
    assert np.array_equal(r.ids.numpy(), np.asarray(jids))
    assert np.allclose(r.weights.numpy(),
                       np.asarray(jw / jw.sum(-1, keepdims=True)), rtol=1e-6)
    keep = jax_keep(np.asarray(jids), jcfg.num_experts, r.cap)
    drops = int((~r.keep).sum())
    assert drops == 128 and drops == int((~keep).sum())
    assert np.array_equal(r.keep.numpy(), keep)
    assert int(r.counts[0]) == 512 and int(r.counts.sum()) == 2 * 512


def test_top_k_ties_follow_lax_top_k():
    """Experts 5 and 9 tie at the top of every row (equal router columns,
    exact sums), with more ties below them: the ids equal ``lax.top_k``'s,
    lower expert first."""
    cfg = f32(smoke_config("grok-1-314b")).replace(num_experts=16)
    rng = np.random.RandomState(5)
    D = cfg.d_model
    x = rng.randint(0, 3, (40, D)).astype(np.float32)
    x[:, 0] = 1.0                                    # every row sums > 0
    router = np.zeros((D, 16), np.float32)
    router[:, 5] = router[:, 9] = 0.125
    router[:, 2] = router[:, 12] = -0.125
    r = L._route(cfg, {"router": torch.from_numpy(router)}, torch.from_numpy(x))
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    _, jids = lax.top_k(probs, cfg.top_k)
    assert np.array_equal(np.asarray(jids), np.tile([5, 9], (40, 1)))
    assert np.array_equal(r.ids.numpy(), np.asarray(jids))
    assert float(r.weights[0, 0]) == float(r.weights[0, 1]) == 0.5


@pytest.mark.parametrize("T, experts, want", [
    (1, 8, 128), (64, 8, 128), (512, 4, 384), (2048, 8, 640), (2048, 128, 128),
    (4096, 8, 1280)])
def test_capacity(T, experts, want):
    """ceil(T*k*cf/E/128)*128, at least 128 (k = 2, cf = 1.25): grok's
    2048-token prefill gets 640 slots per expert, arctic's 128."""
    cfg = smoke_config("grok-1-314b").replace(num_experts=experts)
    assert L.moe_capacity(cfg, T) == want


@pytest.mark.parametrize("share", [0.0, 0.3, 1.0])
def test_real_rows_take_the_capacity_first(share):
    """With a mask of real rows, a real row's choice takes the slot its
    place among the real rows' choices gives, and a padded row's comes
    after every real choice of its expert; all rows real gives the
    unmasked routing bit for bit."""
    cfg = f32(smoke_config("grok-1-314b")).replace(capacity_factor=0.25)
    rng = np.random.RandomState(7)
    T, E, k = 600, cfg.num_experts, cfg.top_k
    xt = torch.from_numpy(rng.randn(T, cfg.d_model).astype(np.float32))
    p = {"router": torch.from_numpy(rng.randn(cfg.d_model, E).astype(np.float32))}
    real = torch.from_numpy(rng.rand(T) >= share)
    r = L._route(cfg, p, xt, real)
    plain = L._route(cfg, p, xt)
    assert torch.equal(r.ids, plain.ids) and torch.equal(r.counts, plain.counts)
    flat = r.ids.reshape(-1).numpy()
    is_real = real.repeat_interleave(k).numpy()
    want = np.empty_like(flat)
    seen_real, seen_pad = np.zeros(E, np.int64), np.zeros(E, np.int64)
    n_real = np.bincount(flat[is_real], minlength=E)
    for i, e in enumerate(flat):
        if is_real[i]:
            want[i], seen_real[e] = seen_real[e], seen_real[e] + 1
        else:
            want[i], seen_pad[e] = n_real[e] + seen_pad[e], seen_pad[e] + 1
    assert np.array_equal(r.slot.numpy(), want)
    assert torch.equal(r.keep, r.slot < r.cap) and not r.keep.all()
    if share == 0.0:
        assert torch.equal(r.slot, plain.slot) and torch.equal(r.keep, plain.keep)


def _zero_padded_rows(q, k, v, pool_k, pool_v, table, pos, adv, *, window=0):
    """The plain paged attention with the rows at or past ``adv`` zeroed,
    as the card's kernel writes them."""
    out = paged_attention_ref(q, k, v, pool_k, pool_v, table, pos, adv, window=window)
    real = torch.arange(q.shape[1])[None, :] < adv[:, None]
    return out * real[:, :, None, None]


@pytest.mark.parametrize("padding", ["other_tokens", "zero_attention"])
def test_decode_chunk_real_rows_do_not_depend_on_the_padding(padding, monkeypatch):
    """A tick whose expert capacity binds (4 slots x chunk 64, cf 0.25:
    128 slots for 512 choices over 4 experts): the real rows' logits
    are the same bits whatever the padded rows hold, other tokens than
    the engine's zeros or the zero attention output the card's kernel
    writes there, because padding takes the capacity last."""
    cfg = f32(smoke_config("arctic-480b")).replace(capacity_factor=0.25)
    params = lm.init_params(cfg, 0, "cpu")
    B, C, bs = 4, 64, 16
    nb = 8
    pos = torch.tensor([40, 0, 70, 3], dtype=torch.int32)
    adv = torch.tensor([1, 64, 0, 23], dtype=torch.int32)
    table = torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb)
    rng = np.random.RandomState(8)
    real = torch.arange(C)[None, :] < adv[:, None]
    toks = torch.from_numpy(rng.randint(1, cfg.vocab_size, (B, C)).astype(np.int32))
    toks = torch.where(real, toks, 0)                     # the engine's padding
    drops = []
    route = L._route

    def counting(*a):
        r = route(*a)
        drops.append(int((~r.keep).sum()))
        return r

    monkeypatch.setattr(L, "_route", counting)
    logits = []
    for variant in (False, True):
        if variant and padding == "other_tokens":
            toks = torch.where(real, toks, torch.from_numpy(
                rng.randint(1, cfg.vocab_size, (B, C)).astype(np.int32)))
        if variant and padding == "zero_attention":
            monkeypatch.setattr(L, "paged_attention", _zero_padded_rows)
        cache = lm.init_paged_cache(cfg, B, 1 + B * nb, bs, "cpu")
        g = torch.Generator().manual_seed(9)
        for a in cache["kv"].values():
            a[:, 1:] = torch.randn(a[:, 1:].shape, generator=g)
        with torch.no_grad():
            lg, _ = lm.decode_chunk(cfg, params, toks, cache, table, pos, adv)
        logits.append(lg[real])
    assert torch.equal(logits[0], logits[1])
    assert sum(drops) > 0             # the capacity binds


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

_WORLDS = {}


def world(arch):
    if arch not in _WORLDS:
        jcfg = f32(jax_smoke_config(arch))
        jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _WORLDS[arch] = (jcfg, f32(smoke_config(arch)), jp, tp)
    return _WORLDS[arch]


def serve(engine, staggered):
    """Greedy tokens of one request alone, or of three with staggered
    joins (the second joins mid-prefill of the first, the third queues)."""
    r1 = engine.submit([5, 9, 2, 7, 3], max_new_tokens=6)
    if not staggered:
        engine.run()
        return [r1.generated]
    engine.step()
    r2 = engine.submit([8, 1, 4, 4, 2, 6], max_new_tokens=6)
    engine.step()
    r3 = engine.submit([9, 8, 7, 6], max_new_tokens=5)
    engine.run()
    return [r1.generated, r2.generated, r3.generated]


@pytest.mark.parametrize("staggered", [False, True], ids=["alone", "staggered"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_greedy_tokens_match_jax(arch, staggered):
    """Both engines route every row of a tick, idle and padded rows
    included (2 slots x chunk 4: 8 rows, far below the 128 slots, where
    the port's order, real rows first, changes nothing)."""
    jcfg, tcfg, jp, tp = world(arch)
    kw = dict(batch_slots=2, max_len=64, prefill_chunk=4)
    want = serve(JaxServeEngine(jcfg, jp, **kw), staggered)
    got = serve(ServeEngine(tcfg, tp, device="cpu", **kw), staggered)
    assert got == want and all(len(g) >= 5 for g in got)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_serve_moe_smoke_on_cpu(arch):
    from repro_torch.launch import serve as launch
    out = launch.main(["--smoke", "--device", "cpu", "--arch", arch, "--requests", "3",
                       "--slots", "2", "--new-tokens", "3"])
    assert out["arch"] == arch and out["completed"] == 3 and out["failed"] == 0


# ---------------------------------------------------------------------------
# The in-place stacked init
# ---------------------------------------------------------------------------

def _list_stack_param(self, name, shape, axes, init=modules.he_normal, dtype=None,
                      fan_in=None):
    """``Builder.param`` as it was: each layer drawn by ``torch.randn``
    and cast out of place, the layers kept in a list and stacked."""
    shape = tuple(int(s) for s in shape)
    dtype = dtype if dtype is not None else self.param_dtype
    if fan_in is None:
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    gen = torch.Generator(device=self.device)
    gen.manual_seed(self.seed * 2**32 + modules._path_seed(f"{self.path}/{name}"))
    if self._stack is None:
        return init(gen, shape, dtype, self.device, fan_in).to(dtype)
    return torch.stack([init(gen, shape, dtype, self.device, fan_in).to(dtype)
                        for _ in range(self._stack)])


def _bits(t):
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("arch", sorted(TORCH_ARCHS))
def test_builder_matches_list_and_stack_init(arch, monkeypatch):
    cfg = smoke_config(arch)
    new = _flat(lm.init_params(cfg, 3, "cpu"))
    monkeypatch.setattr(modules.Builder, "param", _list_stack_param)
    monkeypatch.setattr(modules, "_randn", lambda gen, shape, device: torch.randn(
        shape, generator=gen, device=device, dtype=torch.float32))
    old = _flat(lm.init_params(cfg, 3, "cpu"))
    assert sorted(new) == sorted(old)
    for k, t in new.items():
        assert t.dtype == old[k].dtype and t.shape == old[k].shape, k
        assert torch.equal(_bits(t), _bits(old[k])), k

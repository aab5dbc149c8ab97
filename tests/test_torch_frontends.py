"""The vision (internvl2-1b) and audio (musicgen-medium) frontends of the
port against the JAX package, on the CPU, at smoke size in f32.

The text-only paths of both families ride the arch parametrisations of
``test_torch_models.py`` (config, parameter tree, forward, prefill,
decode). Here: ``forward`` and ``prefill`` with an image prefix, the
cache the prefix leaves and the decode after it; the port's paged
``decode_chunk`` against its own ``forward`` for both families; the
serving engine's greedy tokens against the JAX engine's (audio: codebook
0 of the broadcast codes), with staggered joins; ``launch.serve``.

Tolerances: port vs JAX 1e-4 relative (summation order only), the
cache 1e-5; decode vs forward 2e-3 relative, the bound of
``test_decode.py``; greedy tokens exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import lm
from repro_torch.serve.engine import ServeEngine

FRONTENDS = ["internvl2-1b", "musicgen-medium"]


def f32(cfg):
    return cfg.replace(compute_dtype="float32", param_dtype="float32")


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


_WORLDS = {}


def world(arch):
    """(jax cfg, torch cfg, jax params, torch params) on shared weights,
    the qkv biases randomized (they init to 0)."""
    if arch not in _WORLDS:
        jcfg = f32(jax_smoke_config(arch))
        tree = jax.tree.map(np.asarray, jlm.init_params(jcfg, jax.random.PRNGKey(5)))
        rng = np.random.RandomState(8)
        attn = tree["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            if name in attn:
                attn[name] = (rng.randn(*attn[name].shape) * 0.1).astype(np.float32)
        _WORLDS[arch] = (jcfg, f32(smoke_config(arch)), jax.tree.map(jnp.asarray, tree),
                         convert.params_from_jax(tree, "cpu"))
    return _WORLDS[arch]


def batch(cfg, B, S, seed, image=True):
    """Seeded numpy inputs: ids (codes (B,S,ncb) for audio) and, for
    vision with ``image``, patch embeddings (B,P,vit_dim)."""
    rng = np.random.RandomState(seed)
    shape = (B, S, cfg.num_codebooks) if cfg.frontend == "audio" else (B, S)
    out = {"tokens": rng.randint(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.frontend == "vision" and image:
        out["patch_embeds"] = rng.randn(B, cfg.num_patches, cfg.vit_dim).astype(np.float32)
    return out


def as_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def as_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_image_prefixed_forward_matches_jax(impl):
    jcfg, tcfg, jp, tp = world("internvl2-1b")
    b = batch(jcfg, 2, 12, seed=1)
    want, _ = jlm.forward(jcfg, jp, as_jax(b), attention_impl=impl, remat="none")
    got, _ = lm.forward(tcfg, tp, as_torch(b), attention_impl=impl)
    assert got.shape == (2, jcfg.num_patches + 12, jcfg.vocab_size)
    assert rel_err(got.numpy(), want) < 1e-4


def test_image_prefix_changes_the_text_logits():
    """The projector's output reaches the text: without the image the
    text positions' logits differ."""
    _, tcfg, _, tp = world("internvl2-1b")
    b = batch(tcfg, 1, 6, seed=2)
    with_img, _ = lm.forward(tcfg, tp, as_torch(b))
    text_only, _ = lm.forward(tcfg, tp, {"tokens": torch.from_numpy(b["tokens"])})
    assert float((with_img[:, tcfg.num_patches:] - text_only).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", FRONTENDS)
def test_prefill_and_cache_match_jax(arch):
    """Vision with its image prefix (the cache and the clocks count it),
    audio on codes; then decode_step continues from the cache as JAX's
    does."""
    jcfg, tcfg, jp, tp = world(arch)
    b = batch(jcfg, 2, 9, seed=3)
    S = 9 + (jcfg.num_patches if jcfg.frontend == "vision" else 0)
    want, jc = jlm.prefill(jcfg, jp, as_jax(b), max_len=S + 4)
    got, tc = lm.prefill(tcfg, tp, as_torch(b), max_len=S + 4)
    assert rel_err(got.numpy(), want) < 1e-4
    assert tc["pos"].tolist() == np.asarray(jc["pos"]).tolist() == [S, S]
    for name in ("k", "v"):
        assert tc["kv"][name].shape == jc["kv"][name].shape
        assert rel_err(tc["kv"][name].numpy(), jc["kv"][name]) < 1e-5
    nxt = batch(jcfg, 2, 3, seed=4, image=False)["tokens"]
    for t in range(3):
        jl, jc = jlm.decode_step(jcfg, jp, jnp.asarray(nxt[:, t:t + 1]), jc)
        tl, tc = lm.decode_step(tcfg, tp, torch.from_numpy(nxt[:, t:t + 1]), tc)
        assert rel_err(tl.numpy(), jl) < 1e-4, t


@pytest.mark.parametrize("arch", FRONTENDS)
def test_decode_chunk_matches_forward(arch):
    """The paged decode_chunk, fed in mixed chunks (7 then 13 tokens
    for slot 0, token by token then 16 for slot 1), against forward."""
    _, tcfg, _, tp = world(arch)
    B, S, bs, nb = 2, 20, 8, 4
    toks = batch(tcfg, B, S, seed=5, image=False)["tokens"]
    full, _ = lm.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)})
    cache = lm.init_paged_cache(tcfg, B, 1 + B * nb, bs, "cpu")
    table = torch.arange(1, 1 + B * nb, dtype=torch.int32).reshape(B, nb)
    pos = np.zeros(B, np.int32)
    for adv in ([7, 1], [13, 1], [0, 1], [0, 1], [0, 16]):
        adv = np.array(adv, np.int32)
        C = 1 if adv.max() <= 1 else 16
        f = np.zeros((B, C) + toks.shape[2:], np.int32)
        for i in range(B):
            f[i, :adv[i]] = toks[i, pos[i]:pos[i] + adv[i]]
        logits, cache = lm.decode_chunk(tcfg, tp, torch.from_numpy(f), cache, table,
                                        torch.from_numpy(pos), torch.from_numpy(adv))
        for i in range(B):
            if adv[i]:
                got = logits[i, :adv[i]].numpy()
                want = full[i, pos[i]:pos[i] + adv[i]].numpy()
                assert rel_err(got, want) < 2e-3, (i, pos[i])
        pos = pos + adv
    assert pos.tolist() == [S, S]


@pytest.mark.parametrize("arch", FRONTENDS)
def test_engine_greedy_tokens_match_jax(arch):
    """Staggered joins, chunked prefill; for audio each fed token goes
    to every codebook and codebook 0 is sampled on both sides."""
    jcfg, tcfg, jp, tp = world(arch)
    kw = dict(batch_slots=2, max_len=48, prefill_chunk=4)
    out = []
    for eng in (JaxServeEngine(jcfg, jp, **kw), ServeEngine(tcfg, tp, device="cpu", **kw)):
        r1 = eng.submit([5, 9, 2, 7, 3], max_new_tokens=6)
        eng.step()
        r2 = eng.submit([8, 1, 4, 4, 2, 6], max_new_tokens=6)
        eng.step()
        r3 = eng.submit([9, 8, 7, 6], max_new_tokens=5)
        eng.run()
        assert r1.done and r2.done and r3.done
        out.append([r1.generated, r2.generated, r3.generated])
    assert out[0] == out[1]


def test_audio_engine_feeds_broadcast_codes():
    """The engine hands decode_chunk (B, C, ncb) codes that are a view of
    the (B, C) feed (stride 0 over the codebooks), and every codebook
    stream holds the prompt."""
    _, tcfg, _, tp = world("musicgen-medium")
    eng = ServeEngine(tcfg, tp, batch_slots=2, max_len=32, prefill_chunk=4, device="cpu")
    seen = []
    step = eng._step

    def spy(params, tokens, *args, **kw):
        seen.append(tokens)
        return step(params, tokens, *args, **kw)

    eng._step = spy
    eng.submit([3, 1, 4, 1, 5], max_new_tokens=2)
    eng.run()
    first = seen[0]
    assert first.shape == (2, 4, tcfg.num_codebooks) and first.stride(-1) == 0
    assert first[0, :, 1].tolist() == [3, 1, 4, 1]


@pytest.mark.parametrize("arch", FRONTENDS)
def test_launch_serve_smoke_on_cpu(arch):
    from repro_torch.launch import serve
    out = serve.main(["--smoke", "--device", "cpu", "--arch", arch, "--requests", "8",
                      "--slots", "4", "--new-tokens", "3"])
    assert out["arch"] == arch and out["completed"] == 8 and out["failed"] == 0
    assert out["generated_tokens"] == 24

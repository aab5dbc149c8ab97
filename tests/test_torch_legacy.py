"""The port's legacy fixed-width serve engine against the JAX package's.

``repro_torch.serve.legacy.LegacyServeEngine`` runs the port's
``lm.decode_step`` over the dense cache with one scalar clock. On the
same f32 smoke weights (carried over by ``repro_torch.convert``) and
prompts it gives exactly the JAX legacy engine's greedy tokens: four
requests admitted together, a recycled slot (its KV contamination
included), the audio config, a clock run past ``max_len`` (the writes
dropped, as JAX's scatter drops them) and temperature sampling from
``np.random.RandomState(seed)``. Then the bug demonstrations of
``tests/test_serve.py``: each of the legacy engine's bugs shows on the
port's legacy engine and is fixed in the port's ``ServeEngine``. Last,
``repro_torch.models.registry`` is the configs registry.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402

from repro.configs.registry import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve.legacy import LegacyServeEngine as JaxLegacyServeEngine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as configs_registry  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.models import registry as models_registry  # noqa: E402
from repro_torch.serve.engine import (DeadlineExceededError, EmptyPromptError,  # noqa: E402
                                      ServeEngine)
from repro_torch.serve.legacy import LegacyRequest, LegacyServeEngine  # noqa: E402

A_PROMPT = [1, 2, 3]
B_PROMPT = [9, 8, 7, 6]
PROMPT = [5, 3, 9, 1, 7, 2]


def f32(cfg):
    return cfg.replace(compute_dtype="float32", param_dtype="float32")


_WORLDS = {}


def world(arch):
    """(jax cfg, torch cfg, jax params, torch params) on shared weights."""
    if arch not in _WORLDS:
        jcfg = f32(jax_smoke_config(arch))
        jp = jlm.init_params(jcfg, jax.random.PRNGKey(0))
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
        _WORLDS[arch] = (jcfg, f32(smoke_config(arch)), jp, tp)
    return _WORLDS[arch]


def engines(arch, **kw):
    """The JAX and the port's legacy engine on one world."""
    jcfg, tcfg, jp, tp = world(arch)
    return (JaxLegacyServeEngine(jcfg, jp, **kw),
            LegacyServeEngine(tcfg, tp, device="cpu", **kw))


def serve_both(arch, prompts, max_new_tokens=6, temperature=0.0, **kw):
    """Each engine's generated tokens, per request in submit order, and
    the requests the port's run returned."""
    jeng, teng = engines(arch, **kw)
    out = []
    for eng in (jeng, teng):
        reqs = [eng.submit(p, max_new_tokens=max_new_tokens, temperature=temperature)
                for p in prompts]
        done = eng.run()
        out.append(([r.generated for r in reqs], done))
    (jtoks, _), (ttoks, tdone) = out
    return jtoks, ttoks, tdone


def port_fresh(prompt):
    """B alone through the port's continuous-batching engine."""
    _, tcfg, _, tp = world("yi-34b")
    eng = ServeEngine(tcfg, tp, batch_slots=1, max_len=64, prefill_chunk=4,
                      device="cpu")
    eng.submit(prompt, max_new_tokens=6)
    return eng.run()[0].generated


def test_four_requests_admitted_together_equal_jax():
    """danube's smoke config (a 16-token sliding window): four prompts of
    different lengths join at once and catch up token by token."""
    prompts = [[3, 1, 4], [1, 5, 9, 2, 6, 5, 3], [5], [8, 9, 7, 9, 3, 2, 3, 8, 4, 6]]
    jtoks, ttoks, done = serve_both("h2o-danube-1.8b", prompts, max_new_tokens=8,
                                    batch_slots=4, max_len=64)
    assert ttoks == jtoks
    assert all(len(t) == 8 for t in ttoks)
    assert len(done) == 4 and all(isinstance(r, LegacyRequest) and r.done for r in done)


def test_recycled_slot_equals_jax_bugs_included():
    """One slot, A then B: B starts at A's clock with A's K/V visible.
    The port contaminates exactly as JAX does."""
    jtoks, ttoks, done = serve_both("yi-34b", [A_PROMPT, B_PROMPT], batch_slots=1,
                                    max_len=64)
    assert ttoks == jtoks
    assert [r.generated for r in done] == ttoks
    assert ttoks[1] != port_fresh(B_PROMPT)


def test_audio_config_equals_jax():
    """musicgen: the fed token goes to every codebook, codebook 0 is sampled."""
    prompts = [[3, 1, 4, 1], [5, 9], [2, 6, 5]]
    jtoks, ttoks, _ = serve_both("musicgen-medium", prompts, max_new_tokens=5,
                                 batch_slots=2, max_len=64)
    assert ttoks == jtoks


def test_clock_past_max_len_equals_jax():
    """Bug 2 kept: nothing bounds the scalar clock. yi-34b's smoke config
    has no sliding window, so past max_len = 8 every K/V write is dropped
    (JAX's scatter drops it; the port's attention_decode too) and both
    keep serving the same tokens."""
    jtoks, ttoks, _ = serve_both("yi-34b", [A_PROMPT, B_PROMPT], max_new_tokens=10,
                                 batch_slots=1, max_len=8)
    assert ttoks == jtoks
    _, teng = engines("yi-34b", batch_slots=1, max_len=8)
    teng.submit(A_PROMPT, max_new_tokens=10)
    teng.run()
    assert int(teng.cache["pos"]) == 12 > teng.max_len


def test_temperature_sampling_equals_jax():
    """np.random.RandomState(seed) draws the same tokens from equal logits."""
    jtoks, ttoks, _ = serve_both("yi-34b", [PROMPT, A_PROMPT], max_new_tokens=6,
                                 temperature=0.8, batch_slots=2, max_len=64, seed=3)
    assert ttoks == jtoks


# ---------------------------------------------------------------------------
# The bug demonstrations of tests/test_serve.py on the port: each shows on
# the legacy engine and not on the continuous-batching ServeEngine
# ---------------------------------------------------------------------------


class TestContaminationRegression:
    def test_legacy_engine_contaminates_recycled_slot(self):
        _, tcfg, _, tp = world("yi-34b")
        leg = LegacyServeEngine(tcfg, tp, batch_slots=1, max_len=64, device="cpu")
        leg.submit(A_PROMPT, max_new_tokens=6)
        leg.submit(B_PROMPT, max_new_tokens=6)
        second = leg.run()[1].generated
        assert second != port_fresh(B_PROMPT)

    def test_recycled_slot_equals_fresh_engine(self):
        _, tcfg, _, tp = world("yi-34b")
        eng = ServeEngine(tcfg, tp, batch_slots=1, max_len=64, prefill_chunk=4,
                          device="cpu")
        ra = eng.submit(A_PROMPT, max_new_tokens=6)
        rb = eng.submit(B_PROMPT, max_new_tokens=6)
        out = eng.run()
        assert [r.done for r in out] == [True, True]
        assert ra.generated == port_fresh(A_PROMPT)
        assert rb.generated == port_fresh(B_PROMPT)


class TestRequestErrors:
    def test_legacy_engine_crashes_on_empty_prompt(self):
        _, tcfg, _, tp = world("yi-34b")
        leg = LegacyServeEngine(tcfg, tp, batch_slots=2, max_len=64, device="cpu")
        r = leg.submit([], max_new_tokens=4)         # accepted: the bug
        assert leg.pending == [r]
        with pytest.raises(IndexError):
            leg.run()

    def test_empty_prompt_fails_typed_at_submit(self):
        _, tcfg, _, tp = world("yi-34b")
        eng = ServeEngine(tcfg, tp, batch_slots=2, max_len=64, prefill_chunk=4,
                          device="cpu")
        r = eng.submit([], max_new_tokens=4)
        assert r.failed and isinstance(r.error, EmptyPromptError)
        ok = eng.submit(PROMPT, max_new_tokens=4)
        out = eng.run()
        assert ok.done and {id(x) for x in out} == {id(r), id(ok)}

    def test_legacy_run_drops_unfinished_requests(self):
        _, tcfg, _, tp = world("yi-34b")
        leg = LegacyServeEngine(tcfg, tp, batch_slots=1, max_len=64, device="cpu")
        leg.submit(A_PROMPT, max_new_tokens=20)
        leg.submit(B_PROMPT, max_new_tokens=20)
        got = leg.run(max_steps=3)
        assert got == []                        # both vanished (the bug)

    def test_run_reports_timeouts_instead_of_dropping(self):
        _, tcfg, _, tp = world("yi-34b")
        eng = ServeEngine(tcfg, tp, batch_slots=1, max_len=64, device="cpu")
        a = eng.submit(A_PROMPT, max_new_tokens=20)
        b = eng.submit(B_PROMPT, max_new_tokens=20)
        out = eng.run(max_steps=3)
        assert {id(r) for r in out} == {id(a), id(b)}
        assert all(r.failed and isinstance(r.error, DeadlineExceededError)
                   for r in out)
        assert eng.kv.used_blocks == 0          # slots recycled on failure


def test_models_registry_is_the_configs_registry():
    assert models_registry.ARCHS is configs_registry.ARCHS
    assert models_registry.get_config is configs_registry.get_config
    assert models_registry.smoke_config is configs_registry.smoke_config
    assert models_registry.__all__ == ["ARCHS", "get_config", "smoke_config"]

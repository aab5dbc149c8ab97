"""The port's serving data plane against the JAX package's, on the CPU.

* the block/paged ``KVCacheManager`` semantics, mirrored from
  ``test_serve.py`` (no model runs);
* the port's ``ServeEngine`` must give exactly the JAX engine's greedy
  tokens on the same parameters and prompts: chunked prefill, staggered
  joins, a recycled slot (for mamba2 and hymba too, where the SSD state
  reset carries it), and a sliding-window model served past its window;
* typed request errors, ``Router`` dispatch and backpressure, device
  resolution, and the ``launch.serve`` entry point.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax

from repro.configs.registry import smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.serve.engine import (CacheOverflowError, DeadlineExceededError,
                                      EmptyPromptError, InvalidTokenError,
                                      ServeEngine)
from repro_torch.serve.kvcache import KVCacheManager
from repro_torch.serve.router import Router, RouterOverloadError
from repro_torch.serve.slo import SloTracker


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


@pytest.fixture(scope="module")
def cfg():
    return world("yi-34b")[1]


@pytest.fixture(scope="module")
def params():
    return world("yi-34b")[3]


def make_engine(cfg, params, **kw):
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", 4)
    return ServeEngine(cfg, params, device="cpu", **kw)


def make_jax_engine(arch, **kw):
    jcfg, _, jp, _ = world(arch)
    kw.setdefault("batch_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_chunk", 4)
    return JaxServeEngine(jcfg, jp, **kw)


def make_port_engine(arch, **kw):
    _, tcfg, _, tp = world(arch)
    return make_engine(tcfg, tp, **kw)


# ---------------------------------------------------------------------------
# KVCacheManager unit semantics (no model execution)
# ---------------------------------------------------------------------------

class TestKVCacheManager:
    def mgr(self, cfg, slots=2, max_len=64, **kw):
        return KVCacheManager(cfg, slots, max_len, device="cpu", **kw)

    def test_sentinel_block_never_allocated(self, cfg):
        m = self.mgr(cfg)
        seen = set()
        m.reserve(0, 64)
        m.reserve(1, 64)
        for slot in range(2):
            seen.update(int(b) for b in m.table[slot] if b)
        assert 0 not in seen
        assert len(seen) == m.used_blocks == 2 * m.blocks_per_slot

    def test_strict_reservation_and_release_roundtrip(self, cfg):
        m = self.mgr(cfg)
        total = m.free_blocks
        assert m.can_reserve(64)
        m.reserve(0, 64)
        assert m.free_blocks == total - m.blocks_per_slot
        assert m.capacity(0) == 64
        m.release(0)
        assert m.free_blocks == total
        assert (m.table[0] == 0).all() and m.pos[0] == 0

    def test_reservation_rejects_when_pool_drained(self, cfg):
        m = self.mgr(cfg, slots=2, max_len=64, num_blocks=1 + 64 // 16)
        m.reserve(0, 64)
        assert not m.can_reserve(16)
        with pytest.raises(RuntimeError):
            m.reserve(1, 16)

    def test_double_reserve_same_slot_raises(self, cfg):
        m = self.mgr(cfg)
        m.reserve(0, 16)
        with pytest.raises(RuntimeError):
            m.reserve(0, 16)

    def test_advance_past_capacity_raises(self, cfg):
        m = self.mgr(cfg)
        m.reserve(0, 16)
        m.advance(0, 16)
        with pytest.raises(RuntimeError):
            m.advance(0, 1)

    def test_budget_beyond_slot_width_unreservable(self, cfg):
        m = self.mgr(cfg, max_len=64)
        assert not m.can_reserve(65)

    def test_zero_queue_is_fixed_width_and_padded(self, cfg):
        m = self.mgr(cfg)
        m.reserve(0, 20)
        zb = m.take_zero_blocks()
        assert zb.shape == (m.slots * m.blocks_per_slot,)
        assert len(zb[zb != m.num_blocks]) == 2
        assert m.take_zero_blocks() is None

    def test_recycled_blocks_requeue_for_zeroing(self, cfg):
        m = self.mgr(cfg)
        m.reserve(0, 16)
        first = [int(b) for b in m.table[0] if b]
        m.take_zero_blocks()
        m.release(0)
        m.reserve(0, 16)
        zb = m.take_zero_blocks()
        assert set(first) <= set(int(b) for b in zb)

    def test_reset_mask_marks_reserving_slots_once(self, cfg):
        m = self.mgr(cfg)
        m.reserve(1, 16)
        assert m.take_reset_slots().tolist() == [False, True]
        assert m.take_reset_slots() is None

    def test_pool_lives_on_the_requested_device(self, cfg):
        m = self.mgr(cfg)
        k = m.cache["kv"]["k"]
        assert k.device.type == "cpu" and k.dtype == torch.float32
        assert k.shape == (cfg.num_layers, m.num_blocks, m.block_size,
                           cfg.num_kv_heads, cfg.resolved_head_dim)


# ---------------------------------------------------------------------------
# Greedy tokens equal to the JAX engine's
# ---------------------------------------------------------------------------

PROMPT = [5, 9, 2, 7, 3]
A_PROMPT = [1, 2, 3]
B_PROMPT = [9, 8, 7, 6]


class TestEquivalenceWithJax:
    @pytest.mark.parametrize("chunk", [1, 4])
    def test_single_request_greedy_tokens(self, chunk):
        out = []
        for make in (make_jax_engine, make_port_engine):
            eng = make("yi-34b", prefill_chunk=chunk)
            eng.submit(PROMPT, max_new_tokens=8)
            (r,) = eng.run()
            assert r.done
            out.append(r.generated)
        assert out[0] == out[1]

    def test_staggered_joins(self):
        out = []
        for make in (make_jax_engine, make_port_engine):
            eng = make("yi-34b")
            r1 = eng.submit(PROMPT, max_new_tokens=6)
            eng.step()                              # r1 mid-prefill...
            r2 = eng.submit([8, 1, 4, 4, 2, 6], max_new_tokens=6)  # ...r2 joins
            eng.step()
            r3 = eng.submit(B_PROMPT, max_new_tokens=5)            # queued
            eng.run()
            out.append([r1.generated, r2.generated, r3.generated])
        assert out[0] == out[1]

    def test_recycled_slot(self):
        out = []
        for make in (make_jax_engine, make_port_engine):
            eng = make("yi-34b", batch_slots=1)
            ra = eng.submit(A_PROMPT, max_new_tokens=6)
            rb = eng.submit(B_PROMPT, max_new_tokens=6)
            eng.run()
            assert ra.done and rb.done
            out.append([ra.generated, rb.generated])
        assert out[0] == out[1]
        fresh = make_port_engine("yi-34b", batch_slots=1)
        fresh.submit(B_PROMPT, max_new_tokens=6)
        assert fresh.run()[0].generated == out[1][1]

    @pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
    def test_ssm_recycled_slot_equals_fresh_engine(self, arch):
        """SSD state is cumulative, so a recycled slot depends on
        decode_chunk's reset_slots: the second request through one slot
        gives the JAX engine's tokens and a fresh engine's."""
        out = []
        for make in (make_jax_engine, make_port_engine):
            eng = make(arch, batch_slots=1)
            ra = eng.submit(A_PROMPT, max_new_tokens=6)
            rb = eng.submit(B_PROMPT, max_new_tokens=6)
            eng.run()
            assert ra.done and rb.done
            out.append([ra.generated, rb.generated])
        assert out[0] == out[1]
        fresh = make_port_engine(arch, batch_slots=1)
        fresh.submit(B_PROMPT, max_new_tokens=6)
        assert fresh.run()[0].generated == out[1][1]

    @pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b"])
    def test_ssm_staggered_joins(self, arch):
        """Mixed prefill/decode chunks: padded rows must not advance a
        slot's SSD recurrence."""
        out = []
        for make in (make_jax_engine, make_port_engine):
            eng = make(arch)
            r1 = eng.submit(PROMPT, max_new_tokens=6)
            eng.step()
            r2 = eng.submit([8, 1, 4, 4, 2, 6], max_new_tokens=6)
            eng.step()
            r3 = eng.submit(B_PROMPT, max_new_tokens=5)
            eng.run()
            out.append([r1.generated, r2.generated, r3.generated])
        assert out[0] == out[1]

    def test_sliding_window_model_past_its_window(self):
        """danube's smoke window is 16: a 23-token prompt and 10 new
        tokens run the paged window mask on both sides."""
        prompt = list(range(3, 26))
        out = []
        for make in (make_jax_engine, make_port_engine):
            eng = make("h2o-danube-1.8b", prefill_chunk=8)
            r = eng.submit(prompt, max_new_tokens=10)
            eng.submit(PROMPT, max_new_tokens=4)
            eng.run()
            out.append(r.generated)
        assert out[0] == out[1]

    def test_temperature_sampling_uses_the_seeded_rng(self):
        out = []
        for make in (make_jax_engine, make_port_engine):
            eng = make("yi-34b", seed=11)
            r = eng.submit(PROMPT, max_new_tokens=6, temperature=0.8)
            eng.run()
            out.append(r.generated)
        assert out[0] == out[1]


# ---------------------------------------------------------------------------
# Typed request errors
# ---------------------------------------------------------------------------

class TestRequestErrors:
    def test_empty_prompt_fails_typed_at_submit(self, cfg, params):
        eng = make_engine(cfg, params)
        r = eng.submit([], max_new_tokens=4)
        assert r.failed and isinstance(r.error, EmptyPromptError)
        ok = eng.submit(PROMPT, max_new_tokens=4)
        out = eng.run()
        assert ok.done and {id(x) for x in out} == {id(r), id(ok)}

    def test_over_budget_prompt_fails_typed(self, cfg, params):
        eng = make_engine(cfg, params, max_len=32)
        r = eng.submit(list(range(30)), max_new_tokens=8)
        assert r.failed and isinstance(r.error, CacheOverflowError)
        assert "max_len" in str(r.error)
        ok = eng.submit(PROMPT, max_new_tokens=4)
        eng.run()
        assert ok.done

    def test_out_of_range_token_fails_typed_and_the_rest_are_served(self):
        """An id outside [0, vocab) fails its request at submit; the
        engine serves the other one with the JAX engine's tokens (the
        JAX engine completes the bad request from NaN logits, a
        departure the port makes on purpose)."""
        vocab = world("h2o-danube-1.8b")[1].vocab_size
        good, bad = [1, 2, 3], [5, vocab + 3, 2]
        jeng = make_jax_engine("h2o-danube-1.8b")
        jgood = jeng.submit(good, max_new_tokens=4)
        jeng.submit(bad, max_new_tokens=4)
        jeng.run()
        eng = make_port_engine("h2o-danube-1.8b")
        rg = eng.submit(good, max_new_tokens=4)
        rb = eng.submit(bad, max_new_tokens=4)
        assert rb.failed and isinstance(rb.error, InvalidTokenError)
        assert str(vocab + 3) in str(rb.error)
        out = eng.run()
        assert {id(r) for r in out} == {id(rg), id(rb)}
        assert rg.done and rg.generated == jgood.generated
        neg = eng.submit([-1, 4], max_new_tokens=2)
        assert neg.failed and isinstance(neg.error, InvalidTokenError)

    def test_run_reports_timeouts_instead_of_dropping(self, cfg, params):
        eng = make_engine(cfg, params, batch_slots=1)
        a = eng.submit(A_PROMPT, max_new_tokens=20)
        b = eng.submit(B_PROMPT, max_new_tokens=20)
        out = eng.run(max_steps=3)
        assert {id(r) for r in out} == {id(a), id(b)}
        assert all(r.failed and isinstance(r.error, DeadlineExceededError)
                   for r in out)
        assert eng.kv.used_blocks == 0

    def test_terminal_requests_carry_latency_telemetry(self, cfg, params):
        ticks = iter(range(100))
        eng = make_engine(cfg, params, clock=lambda: float(next(ticks)))
        r = eng.submit(PROMPT, max_new_tokens=4)
        eng.run()
        assert r.done and r.ttft_s > 0 and r.tpot_s > 0
        assert r.latency_s >= r.ttft_s
        assert eng.stats()["completed"] == 1 and eng.stats()["steps"] == 5


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

class TestRouter:
    def pair(self, cfg, params, slo=None, max_queue=2):
        router = Router(slo, max_queue_per_replica=max_queue)
        router.add_replica("r0", make_engine(cfg, params), arm="baseline")
        router.add_replica("r1", make_engine(cfg, params), arm="canary")
        return router

    def test_dispatch_balances_by_load(self, cfg, params):
        router = self.pair(cfg, params, max_queue=4)
        for i in range(6):
            router.submit([1 + i, 2, 3], max_new_tokens=2)
        assert router.dispatched == {"r0": 3, "r1": 3}

    def test_backpressure_rejects_at_submit(self, cfg, params):
        router = self.pair(cfg, params, max_queue=2)
        for i in range(4):
            router.submit([1 + i, 2], max_new_tokens=2)
        with pytest.raises(RouterOverloadError):
            router.submit([1, 2], max_new_tokens=2)
        assert router.rejected == 1
        done = router.run()
        assert len(done) == 4 and all(r.done for r in done)

    def test_removed_replica_drains_and_feeds_slo(self, cfg, params):
        slo = SloTracker()
        router = self.pair(cfg, params, slo=slo, max_queue=4)
        r = router.submit(PROMPT, max_new_tokens=4)
        router.step()
        router.remove_replica("r0")
        assert "r0" not in router.replica_names()
        router.run()
        assert r.done
        snap = slo.arm_snapshot("baseline")
        assert snap["samples"] == 1 and snap["p95_ttft_ms"] > 0


# ---------------------------------------------------------------------------
# Devices and the entry point
# ---------------------------------------------------------------------------

def test_default_device_without_cuda_raises(monkeypatch, cfg, params):
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        lm.init_params(cfg)
    with pytest.raises(RuntimeError):
        ServeEngine(cfg, params)
    assert resolve_device("cpu").type == "cpu"


def test_launch_serve_smoke_on_cpu(capsys):
    from repro_torch.launch import serve
    out = serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                      "--slots", "2", "--new-tokens", "3", "--replicas", "2"])
    assert out["completed"] == 3 and out["failed"] == 0
    assert out["generated_tokens"] == 9 and out["device"] == "cpu"
    assert sum(out["dispatch"].values()) == 3
    assert '"completed": 3' in capsys.readouterr().out

"""The program's spans (``repro_torch.obs.span``) on the CPU.

* outside a profile ``span`` is the shared no-op, builds nothing and
  marks no tensor, in a serving tick and in a train step;
* inside a ``torch.profiler`` profile a tick records each engine phase
  once, in order, and each layer's mixer once;
* a ``remat="full"`` train step records each sub-layer's forward, its
  recompute and its ``.bwd`` range, every ``.bwd`` range closed on the
  thread that opened it and none left open, also when the step raises;
* the numbers are bit-equal with and without the profile.
"""

import threading
from collections import Counter

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from torch.profiler import ProfilerActivity, profile  # noqa: E402
from torch.utils._pytree import tree_leaves, tree_map  # noqa: E402

import repro_torch.obs as obs  # noqa: E402
from repro_torch.configs.registry import smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.obs import trace as otrace  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.train_step import (StepConfig, init_train_state,  # noqa: E402
                                          make_train_step)

ARCHS = {"dense": "h2o-danube-1.8b", "ssm": "mamba2-780m"}
ENGINE = ["serve.admit", "serve.feed", "serve.model", "serve.readback", "serve.sample"]


def f32(cfg):
    return cfg.replace(compute_dtype="float32", param_dtype="float32")


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def ranges(prof):
    """(name without prefix, start, end, thread) of the program's ranges, by start."""
    out = [(e.name[len(obs.SPAN_PREFIX):], e.time_range.start, e.time_range.end, e.thread)
           for e in prof.events() if e.name.startswith(obs.SPAN_PREFIX)]
    return sorted(out, key=lambda r: r[1])


def engine(family):
    cfg = f32(smoke_config(ARCHS[family]))
    eng = ServeEngine(cfg, lm.init_params(cfg, 0, "cpu"), batch_slots=2, max_len=64,
                      prefill_chunk=8, device="cpu")
    for n in (11, 5):
        eng.submit(list(range(1, n + 1)), 4)
    return cfg, eng


def train_step(family, remat="full"):
    cfg = f32(smoke_config(ARCHS[family]))
    opt = AdamW(lambda s: 1e-3)
    step = make_train_step(cfg, opt, StepConfig(remat=remat))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}
    return cfg, step, init_train_state(cfg, opt, 0, "cpu"), batch


def test_outside_a_profile_span_is_the_shared_noop():
    s = obs.span("model.attention")
    assert s is obs.NO_SPAN and obs.span("serve.feed") is obs.NO_SPAN
    t, u = torch.ones(2, requires_grad=True), torch.zeros(2)
    with s as entered:
        assert entered is obs.NO_SPAN
        assert entered.inputs(t) is t and entered.inputs(t, u) == (t, u)
        assert entered.output(t) is t


def test_the_flag_is_torchs_process_wide_profiler_flag():
    # torch.autograd.profiler._is_profiler_enabled: set while any thread's
    # profile records, read in every thread (the C++ flag is per thread)
    seen = {}

    def other_thread():
        seen["other"] = obs.span("x") is not obs.NO_SPAN

    assert not torch.autograd.profiler._is_profiler_enabled
    with cpu_profile():
        assert torch.autograd.profiler._is_profiler_enabled
        seen["this"] = obs.span("x") is not obs.NO_SPAN
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(30)
    assert not t.is_alive()
    assert seen == {"this": True, "other": True}
    assert obs.span("x") is obs.NO_SPAN


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_off_path_builds_no_span_and_adds_no_autograd_node(monkeypatch, family):
    def no_span(name):
        raise AssertionError(f"a span object was built for {name} outside a profile")

    monkeypatch.setattr(otrace, "_Span", no_span)
    monkeypatch.setattr(otrace, "_marks", lambda: no_span("a mark"))
    _, eng = engine(family)
    assert eng.step()
    cfg, step, state, batch = train_step(family)
    _, metrics = step(state, batch)
    assert torch.isfinite(metrics["loss"])


def _graph_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    return Counter(type(fn).__name__ for fn in seen)


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_marks_are_autograd_nodes_only_inside_a_profile(family):
    cfg, _, state, batch = train_step(family, remat="none")
    live = tree_map(lambda p: p.detach().requires_grad_(True), state["params"])
    off, _ = lm.train_loss(cfg, live, batch, remat="none")
    with cpu_profile():
        on, _ = lm.train_loss(cfg, live, batch, remat="none")
    n_off, n_on = _graph_nodes(off), _graph_nodes(on)
    marks = Counter({k: v for k, v in n_on.items() if "OnGrad" in k})
    assert not any("OnGrad" in k for k in n_off)
    # an open and a close mark per sub-layer: attention and MLP, or the
    # SSD layer and its scan
    assert sum(marks.values()) == 4 * cfg.num_layers
    assert n_on - marks == n_off


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_a_tick_records_each_engine_phase_once_in_order(family):
    cfg, eng = engine(family)
    eng.step()
    with cpu_profile() as prof:
        assert eng.step()
    rs = ranges(prof)
    assert [n for n, *_ in rs if n.startswith("serve.")] == ENGINE
    counts = Counter(n for n, *_ in rs)
    mixer = "model.ssd" if family == "ssm" else "model.attention"
    assert counts[mixer] == cfg.num_layers
    assert counts["model.embed"] == counts["model.head"] == 1
    model = next(r for r in rs if r[0] == "serve.model")
    inside = [n for n, s, e, _ in rs if n.startswith("model.") and model[1] <= s and e <= model[2]]
    assert Counter(inside) == Counter(n for n, *_ in rs if n.startswith("model."))


@pytest.mark.parametrize("family", sorted(ARCHS))
def test_remat_full_records_forward_recompute_and_backward(monkeypatch, family):
    cfg, step, state, batch = train_step(family)
    opened, closed = {}, {}
    orig_open, orig_close = otrace._BackwardRange.open, otrace._BackwardRange.close

    def spy_open(self):
        if self._range is None:
            opened[id(self)] = threading.get_ident()
        orig_open(self)

    def spy_close(self):
        if self._range is not None:
            closed[id(self)] = threading.get_ident()
        orig_close(self)

    monkeypatch.setattr(otrace._BackwardRange, "open", spy_open)
    monkeypatch.setattr(otrace._BackwardRange, "close", spy_close)
    with cpu_profile() as prof:
        step(state, batch)
    L = cfg.num_layers
    counts = Counter(n for n, *_ in ranges(prof))
    subs = ["model.ssd", "model.ssd.scan"] if family == "ssm" else ["model.attention",
                                                                  "model.mlp"]
    for sub in subs:
        assert counts[sub] == 2 * L, sub            # forward and recompute
        assert counts[sub + ".bwd"] == L, sub
    for name in ("train.grads", "train.clip", "train.optimizer", "model.embed",
                 "model.head", "model.loss"):
        assert counts[name] == 1, name
    assert opened and opened == closed              # each on the thread that opened it
    assert not otrace._open_backward
    rs = ranges(prof)
    assert all(e >= s for _, s, e, _ in rs)
    # the recompute runs inside the backward range that needed it, which
    # its early stop (an exception inside the recomputed body) leaves open
    # (the dense layer's backward starts in its MLP; the SSD layer's in itself)
    outer = "model.ssd.bwd" if family == "ssm" else "model.mlp.bwd"
    bwd = [(s, e) for n, s, e, _ in rs if n == outer]
    recomputed = [(s, e) for n, s, e, _ in rs if n == subs[0]][L:]
    assert len(bwd) == len(recomputed) == L
    assert all(any(bs <= s and e <= be for bs, be in bwd) for s, e in recomputed)


def test_a_hybrid_layers_mixers_have_backward_ranges_one_after_the_other():
    # both mixers read the normed rows; the attention's backward runs
    # first and the SSD's opens after it, not beside it
    cfg = f32(smoke_config("hymba-1.5b"))
    opt = AdamW(lambda s: 1e-3)
    step = make_train_step(cfg, opt, StepConfig(remat="full"))
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32)
             for k in ("tokens", "labels")}
    with cpu_profile() as prof:
        step(init_train_state(cfg, opt, 0, "cpu"), batch)
    rs = [r for r in ranges(prof) if r[0] in ("model.attention.bwd", "model.ssd.bwd")]
    assert [n for n, *_ in rs] == ["model.attention.bwd", "model.ssd.bwd"] * cfg.num_layers
    assert all(a[2] <= b[1] for a, b in zip(rs, rs[1:]))


def test_a_step_that_raises_closes_its_backward_ranges(monkeypatch):
    class Fail(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            raise RuntimeError("backward failed")

    orig = lm.attention_apply
    monkeypatch.setattr(lm, "attention_apply", lambda *a, **k: Fail.apply(orig(*a, **k)))
    _, step, state, batch = train_step("dense")
    with cpu_profile() as prof:
        with pytest.raises(RuntimeError, match="backward failed"):
            step(state, batch)
    assert not otrace._open_backward
    rs = ranges(prof)
    assert Counter(n for n, *_ in rs)["model.attention.bwd"] == 1
    assert all(e >= s for _, s, e, _ in rs)


@pytest.mark.parametrize("family", ["dense", "ssm", "hybrid"])
def test_numbers_are_bit_equal_with_and_without_the_profile(family):
    arch = {"hybrid": "hymba-1.5b"}.get(family, ARCHS.get(family))
    cfg = f32(smoke_config(arch))
    params = lm.init_params(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(2)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g, dtype=torch.int32)
             for k in ("tokens", "labels")}

    def run():
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss, _ = lm.train_loss(cfg, live, batch, remat="full")
        grads = torch.autograd.grad(loss, tree_leaves(live))
        with torch.no_grad():
            logits, _ = lm.forward(cfg, params, batch)
        return loss.detach(), grads, logits

    off = run()
    with cpu_profile():
        on = run()
    assert torch.equal(off[0], on[0]) and torch.equal(off[2], on[2])
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))

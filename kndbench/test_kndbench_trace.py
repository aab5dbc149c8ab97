"""The reduction of the program's spans (``program_trace``) on plain
event lists, and on a traced smoke-size run on the CPU."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from kndbench import harness, program_trace, smoke, trace  # noqa: E402

WIN = ("kndbench.window", 1, 0.0, 1000.0)
MAIN, AUTOGRAD = 1, 2


def k(thread, t, start, end):
    """A kernel launched on ``thread`` at ``t``, run on the device from
    ``start`` to ``end``."""
    return (thread, t, start, end)


def test_a_kernel_counts_under_the_range_of_the_thread_that_launched_it():
    ranges = [WIN, ("knd.model.attention.bwd", AUTOGRAD, 100.0, 200.0),
              ("knd.train.grads", MAIN, 50.0, 400.0), ("knd.train.clip", MAIN, 120.0, 180.0)]
    # launched on the autograd thread while the main thread's clip range was open
    s = program_trace.reduce_program(ranges, [k(AUTOGRAD, 150.0, 160.0, 190.0)])
    assert s.device_s["model.attention.bwd"] == pytest.approx(30e-6)
    assert s.device_s["train.clip"] == 0.0
    assert s.device_s["train.grads"] == 0.0


def test_a_nested_ranges_kernels_count_in_its_parents_total():
    ranges = [WIN, ("knd.model.ssd", MAIN, 100.0, 300.0),
              ("knd.model.ssd.scan", MAIN, 150.0, 250.0),
              ("kndbench.ssd_chunk", MAIN, 160.0, 170.0)]
    kernels = [k(MAIN, 120.0, 400.0, 410.0), k(MAIN, 165.0, 410.0, 430.0),
               k(MAIN, 200.0, 430.0, 460.0)]
    s = program_trace.reduce_program(ranges, kernels)
    assert s.device_s["model.ssd"] == pytest.approx(60e-6)
    assert s.device_s["model.ssd.scan"] == pytest.approx(50e-6)
    assert s.device_s["ssd_chunk"] == pytest.approx(20e-6)
    assert s.calls == {"model.ssd": 1, "model.ssd.scan": 1, "ssd_chunk": 1}
    assert s.host_s["model.ssd"] == pytest.approx(200e-6)


def test_a_kernel_launched_outside_every_range_counts_nowhere():
    ranges = [WIN, ("knd.serve.model", MAIN, 100.0, 200.0)]
    kernels = [k(MAIN, 50.0, 100.0, 150.0), k(MAIN, 250.0, 260.0, 270.0),
               k(None, None, 150.0, 180.0)]          # no launching op known
    s = program_trace.reduce_program(ranges, kernels)
    assert s.device_s["serve.model"] == 0.0
    assert s.busy_s == pytest.approx(90e-6)


def test_sibling_ranges_sum_to_at_most_busy():
    ranges = [WIN] + [("knd.model.attention" if i % 2 else "knd.model.mlp", MAIN,
                       100.0 * i, 100.0 * i + 90.0) for i in range(1, 8)]
    # one stream: each kernel starts when the last ended, some overlap the
    # next range's launches (the host runs ahead of the device)
    kernels, t = [], 0.0
    for i in range(1, 8):
        for j in range(3):
            launch = 100.0 * i + 10.0 * j
            start = max(t, launch + 5.0)
            t = start + 40.0
            kernels.append(k(MAIN, launch, start, t))
    s = program_trace.reduce_program(ranges, kernels)
    siblings = s.device_s["model.attention"] + s.device_s["model.mlp"]
    assert siblings == pytest.approx(s.busy_s)
    assert s.device_union_s("model.attention", "model.mlp") == pytest.approx(s.busy_s)
    assert siblings <= s.window_s


def test_an_idle_gap_is_labelled_by_the_innermost_program_range():
    ranges = [WIN, ("kndbench.tick", MAIN, 0.0, 1000.0),
              ("knd.serve.feed", MAIN, 300.0, 600.0), ("knd.serve.sample", MAIN, 700.0, 900.0)]
    kernels = [k(MAIN, 10.0, 0.0, 400.0), k(MAIN, 310.0, 500.0, 800.0),
               k(MAIN, 320.0, 850.0, 1000.0)]
    s = program_trace.reduce_program(ranges, kernels)
    assert dict(s.idle_gaps) == pytest.approx({"serve.feed": 100e-6, "serve.sample": 50e-6})


def test_without_program_ranges_it_reads_as_the_harness_reduction():
    cpu = [("window", 0.0, 1000.0, 0.0), ("tick", 0.0, 600.0, 300.0),
           ("attention_decode_paged", 100.0, 300.0, 150.0), ("tick", 600.0, 1000.0, 200.0)]
    device = [("gemm", 20.0, 250.0), ("softmax", 260.0, 500.0), ("copy", 700.0, 950.0)]
    h = trace.reduce_events(cpu, device)
    ranges = [("kndbench." + n, MAIN, s, e) for n, s, e, _ in cpu]
    p = program_trace.reduce_program(ranges, [k(MAIN, s - 5.0, s, e) for _, s, e in device])
    assert (p.window_s, p.busy_s) == (h.window_s, h.busy_s)
    assert sorted(map(tuple, p.idle_gaps)) == sorted(map(tuple, h.idle_gaps))
    assert h.span_device_s == {"tick": 500e-6, "attention_decode_paged": 150e-6}
    assert p.calls == h.span_calls


def test_a_traced_smoke_run_reads_engine_host_time_and_no_device_share(monkeypatch):
    summaries = []
    orig = trace.summarize

    def summarize(prof):
        summaries.append(program_trace.summarize_program(prof))
        return orig(prof)

    monkeypatch.setattr(trace, "summarize", summarize)
    for name in ("danube-rag", "mamba2-train-4k"):
        c = smoke.cell(name, seed=2**31 + 5, seconds=0.3, trace=True)
        # the traced window first, however slow the machine
        c.traffic = {**c.traffic, "trace_skip_ticks": 0, "trace_skip_steps": 0}
        harness.driver(c.traffic["kind"]).run(c)
    assert len(summaries) == 2
    serve, train = (program_trace.readings(s) for s in summaries)
    assert serve["engine_host_ms.serve"] > 0
    assert serve["attention_device_share.serve"] is None      # no kernels on the CPU
    assert train["attention_device_share.train"] is None
    assert train["ssd_scan_device_share.train"] is None
    assert train["engine_host_ms.serve"] is None
    ticks = summaries[0].calls["serve.model"]
    assert ticks == smoke.SERVE["trace_ticks"]
    for phase in ("serve.admit", "serve.feed", "serve.readback", "serve.sample"):
        assert summaries[0].calls[phase] == ticks
    assert summaries[1].calls["model.ssd.scan.bwd"] == 2 * summaries[1].calls["train.grads"]

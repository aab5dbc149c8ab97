#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

  python3 chip_smoke.py

It builds the hand-written kernels from the checkout's sources and
serves h2o-danube-1.8b at full width and full depth (random weights
from a seed), in phases:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc for the CUDA flash-attention library, Triton's JIT
     for the RMSNorm kernel;
  3. RMSNorm kernel vs its plain version;
  4. flash-attention kernel vs its plain version (and its gradient);
  5. the model in f32: prefill with the flash kernel vs the dense path,
     ServeEngine chunked-prefill first-token logits vs prefill, and a
     request's greedy tokens alone vs beside staggered others;
  6. serving in bf16 through the Router: 8 requests, 4 slots;
  7. the kernels line: launches on the main path (phases 5-6), and each
     kernel's time at the main path's shapes beside its plain version,
     a PyTorch library call computing the same function, and its bound;
     before it, a torch.profiler breakdown of serving ticks.

Any failed check raises, so the exit code is non-zero and no result
line is printed. Without a CUDA device the script exits with code 1
before doing anything. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

SEED = 0
ARCH = "h2o-danube-1.8b"
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_TOL, BF16_TOL = 2e-5, 2e-2     # kernel vs plain, as tests/test_kernels.py


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` launches."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_events(prof):
    """(name, calls, device µs) of every device activity a profile saw."""
    import torch
    out = []
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            out.append((e.key, e.count, us))
    return out


def kernel_device_ms(fn, kernel: str, n: int = 20):
    """Median device duration of the one kernel named ``kernel`` that
    ``fn`` launches, over the launches torch.profiler recorded; None when
    it recorded none. The median of the kernel's own records, not a sum
    over the window divided by ``n``, so a record the profiler drops
    cannot shrink the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.name]
    return statistics.median(us) / 1e3 if us else None


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build():
    import torch
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_fwd
    t0 = time.perf_counter()
    load_library("flash_attention", [fa.SOURCE])
    t1 = time.perf_counter()
    for dt in (torch.float32, torch.bfloat16):
        rmsnorm_fwd(torch.ones(2, 2560, device=DEVICE, dtype=dt),
                    torch.ones(2560, device=DEVICE))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    log(f"[build] nvcc flash_attention: {t1 - t0:.1f} s; "
        f"triton rmsnorm (f32+bf16 JIT): {t2 - t1:.1f} s")


def phase_rmsnorm(gen):
    """Norm weights near their init value of 1. The plain version runs on
    the same inputs in f32 (its final cast left out): kernel and plain
    differ in the last f32 bit (reduction order, rsqrt), and two bf16
    roundings of such values can land one bf16 step (0.03 at |y| >= 4)
    apart; against the f32 value the kernel's error is its own rounding."""
    import torch
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    worst = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for D in (2560, 7168):
            for rows in (1, 64, 4096, 8192):
                x = torch.randn(rows, D, device=DEVICE, generator=gen).to(dtype)
                s = 1 + 0.1 * torch.randn(D, device=DEVICE, generator=gen)
                err = max_abs(rmsnorm(x, s), rmsnorm_ref(x.float(), s))
                check(err <= tol, f"rmsnorm rows={rows} D={D} {dtype}: {err} > {tol}")
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    log(f"[rmsnorm] 16 cases vs plain ok; max abs err {worst}")


def phase_flash(gen):
    import torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    cases = []
    for d in (80, 128):
        for S in (200, 2048):
            for window in (0, 256, 4096):
                cases.append((2 if S == 200 else 1, S, 32, 8, d, True, window))
    cases += [(2, 200, 32, 8, 80, False, 0), (1, 333, 8, 2, 64, True, 100)]
    worst = {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for B, S, H, K, d, causal, window in cases:
            q = torch.randn(B, S, H, d, device=DEVICE, generator=gen).to(dtype)
            k = torch.randn(B, S, K, d, device=DEVICE, generator=gen).to(dtype)
            v = torch.randn(B, S, K, d, device=DEVICE, generator=gen).to(dtype)
            out = flash_attention(q, k, v, causal, window)
            err = max_abs(out, attention_ref(q, k, v, causal=causal, window=window))
            check(err <= tol, f"flash B={B} S={S} H={H} K={K} d={d} causal={causal} "
                              f"window={window} {dtype}: {err} > {tol}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
    # gradient of q through the autograd.Function vs the plain version's
    q, k, v = (torch.randn(1, 64, n, 64, device=DEVICE, generator=gen) for n in (4, 2, 2))
    q1 = q.clone().requires_grad_(True)
    flash_attention(q1, k, v).sum().backward()
    q2 = q.clone().requires_grad_(True)
    attention_ref(q2, k, v).sum().backward()
    gerr = max_abs(q1.grad, q2.grad)
    check(gerr <= 1e-4, f"flash dq: {gerr} > 1e-4")
    log(f"[flash] {2 * len(cases)} cases vs plain ok; max abs err {worst}; "
        f"dq err {gerr:.3g}")


def capture_logits(engine, sink):
    """Wrap the engine's decode step so each tick's logits land in ``sink``."""
    step = engine._step

    def wrapped(*args, **kw):
        logits, cache = step(*args, **kw)
        sink.append(logits)
        return logits, cache

    engine._step = wrapped


def phase_model_f32(rng):
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(ARCH).replace(param_dtype="float32", compute_dtype="float32")
    params = lm.init_params(cfg, SEED, DEVICE)
    S = 2048
    prompt = rng.randint(0, cfg.vocab_size, size=S).tolist()
    toks = torch.tensor([prompt], device=DEVICE)
    with torch.no_grad():
        lk, _ = lm.prefill(cfg, params, {"tokens": toks}, attention_impl="kernel")
        ld, _ = lm.prefill(cfg, params, {"tokens": toks}, attention_impl="dense")
    torch.cuda.synchronize()
    e1 = rel_err(lk, ld)
    check(bool(torch.isfinite(lk).all()) and e1 <= 1e-3,
          f"prefill kernel vs dense: rel err {e1} > 1e-3")

    eng = ServeEngine(cfg, params, batch_slots=2, max_len=S + 16,
                      prefill_chunk=128, device=DEVICE, seed=SEED)
    seen = []
    capture_logits(eng, seen)
    r = eng.submit(prompt, max_new_tokens=4)
    with torch.no_grad():
        eng.run()
    check(r.done, "engine request did not complete")
    first = seen[math.ceil(S / 128) - 1][0, (S - 1) % 128]
    e2 = rel_err(first, lk[0, 0])
    check(e2 <= 2e-3, f"engine first-token logits vs prefill: rel err {e2} > 2e-3")
    check(r.generated[0] == int(lk[0, 0].argmax()), "first greedy token differs")

    # a request's greedy tokens alone == beside staggered others
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist() for n in (96, 40, 150)]
    solo = ServeEngine(cfg, params, batch_slots=4, max_len=256, prefill_chunk=16,
                       device=DEVICE, seed=SEED)
    ra = solo.submit(prompts[0], max_new_tokens=12)
    with torch.no_grad():
        solo.run()
        mixed = ServeEngine(cfg, params, batch_slots=4, max_len=256,
                            prefill_chunk=16, device=DEVICE, seed=SEED)
        rb = mixed.submit(prompts[0], max_new_tokens=12)
        mixed.step()
        mixed.submit(prompts[1], max_new_tokens=12)
        mixed.step()
        mixed.step()
        mixed.submit(prompts[2], max_new_tokens=12)
        mixed.run()
    check(ra.done and rb.done and ra.generated == rb.generated,
          f"staggered joins changed greedy tokens: {ra.generated} vs {rb.generated}")
    log(f"[model f32] {cfg.num_layers} layers d_model {cfg.d_model}: prefill kernel "
        f"vs dense rel err {e1:.3g}; engine first-token vs prefill rel err {e2:.3g}; "
        f"staggered greedy tokens equal ({len(ra.generated)})")
    del params
    torch.cuda.empty_cache()


def phase_serve_bf16(rng):
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.router import Router
    from repro_torch.serve.slo import SloTracker
    cfg = get_config(ARCH)
    check(cfg.param_dtype == "bfloat16" and cfg.compute_dtype == "bfloat16",
          "danube serves in bf16")
    params = lm.init_params(cfg, SEED, DEVICE)
    toks = torch.tensor([rng.randint(0, cfg.vocab_size, size=2048).tolist()],
                        device=DEVICE)
    with torch.no_grad():
        lk, _ = lm.prefill(cfg, params, {"tokens": toks}, attention_impl="kernel")
    check(bool(torch.isfinite(lk.float()).all()), "bf16 prefill logits not finite")

    slo = SloTracker()
    router = Router(slo, max_queue_per_replica=8)
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=1024, prefill_chunk=16,
                      device=DEVICE, seed=SEED)
    router.add_replica("replica-0", eng)
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    seen = []
    capture_logits(eng, seen)
    lens = rng.randint(64, 513, size=8)
    norms_before = launch_counts()["rmsnorm"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for n in lens:
            router.submit(rng.randint(0, cfg.vocab_size, size=int(n)).tolist(),
                          max_new_tokens=32)
        done = router.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for lg in seen:
        finite &= torch.isfinite(lg).all()
    norms = launch_counts()["rmsnorm"] - norms_before
    check(len(done) == 8 and all(r.done for r in done), "not every request completed")
    check(bool(finite), "non-finite logits while serving")
    check(norms == (2 * cfg.num_layers + 1) * eng.steps,
          f"rmsnorm launches {norms} != {2 * cfg.num_layers + 1} x {eng.steps} ticks")
    gen = sum(len(r.generated) for r in done)
    snap = slo.arm_snapshot("baseline")
    stats = {"requests": 8, "prompt_lens": [int(n) for n in lens],
             "new_tokens": 32, "slots": 4, "prefill_chunk": 16,
             "generated_tokens": gen, "ticks": eng.steps, "wall_s": wall,
             "tokens_per_s": gen / wall, "ms_per_tick": 1e3 * wall / eng.steps,
             "p50_ttft_ms": snap["p50_ttft_ms"], "p95_ttft_ms": snap["p95_ttft_ms"],
             "p50_tpot_ms": snap["p50_tpot_ms"], "p95_tpot_ms": snap["p95_tpot_ms"],
             "rmsnorm_launches_serving": norms}
    log(f"[serve bf16] {json.dumps(stats)}")
    return cfg, params


def phase_profile(cfg, params, rng):
    """Where a serving tick's time goes, with 4 slots all prefilling
    16-token chunks and then all decoding one token: wall time per tick
    (unprofiled), device time per tick, the device's idle share and the
    top device activities (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=1024, prefill_chunk=16,
                      device=DEVICE, seed=SEED)
    for _ in range(4):
        eng.submit(rng.randint(0, cfg.vocab_size, size=512).tolist(),
                   max_new_tokens=200)
    out = {}
    n = 8
    with torch.no_grad():
        for regime in ("prefill_chunk16", "decode"):
            if regime == "decode":
                while any(r is not None and r.t_first_token is None
                          for r in eng.active):
                    eng.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                eng.step()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / n
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    eng.step()
                torch.cuda.synchronize()
            evs = kernel_events(prof)
            busy = sum(us for *_, us in evs) / n / 1e3 if evs else None
            top = sorted(evs, key=lambda e: -e[2])[:8]
            out[regime] = {
                "wall_ms_per_tick": wall, "device_ms_per_tick": busy,
                "device_idle_share": None if busy is None else 1 - busy / wall,
                "device_ops_per_tick": sum(c for _, c, _ in evs) / n,
                # 2L+1 per tick when the profiler kept every record
                "rmsnorm_records_per_tick": sum(
                    c for k, c, _ in evs if "_rmsnorm_kernel" in k) / n,
                "top_device_ms_per_tick": [[k[:70], c / n, us / n / 1e3]
                                           for k, c, us in top]}
    check(all(r is not None and r.t_first_token is not None for r in eng.active),
          "profile engine lost a request")
    log(f"[profile] {json.dumps(out)}")


def phase_kernels_line(cfg, launches, gen):
    """Each kernel at the main path's bf16 shapes: kernel, plain version,
    library call, and the bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    out = []
    # RMSNorm at a serving tick: 4 slots x a 16-token chunk, d_model 2560
    D = cfg.d_model
    x = torch.randn(4, 16, D, device=DEVICE, generator=gen).to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(D, device=DEVICE, generator=gen)).to(torch.bfloat16)
    nbytes = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
    lib = None
    if hasattr(F, "rms_norm"):
        lib = time_ms(lambda: F.rms_norm(x, (D,), s, cfg.norm_eps))
    out.append({
        "name": "rmsnorm", "route": "triton",
        "source": "src/repro_torch/kernels/rmsnorm/rmsnorm.py",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:24",
        "launches": launches["rmsnorm"],
        "max_abs_err": max_abs(rmsnorm(x, s, cfg.norm_eps),
                               rmsnorm_ref(x.float(), s, cfg.norm_eps)),
        "ms": time_ms(lambda: rmsnorm(x, s, cfg.norm_eps)),
        "plain_ms": time_ms(lambda: rmsnorm_ref(x, s, cfg.norm_eps)),
        "device_ms": kernel_device_ms(lambda: rmsnorm(x, s, cfg.norm_eps),
                                      "_rmsnorm_kernel"),
        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
        "library_ms": lib, "shape": [4, 16, D], "dtype": "bfloat16"})

    # flash attention at the 2048-token prefill of danube
    B, S, H, K, d, W = 1, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.sliding_window
    q = torch.randn(B, S, H, d, device=DEVICE, generator=gen).to(torch.bfloat16)
    k = torch.randn(B, S, K, d, device=DEVICE, generator=gen).to(torch.bfloat16)
    v = torch.randn(B, S, K, d, device=DEVICE, generator=gen).to(torch.bfloat16)
    pairs = sum(min(i + 1, W) if W > 0 else i + 1 for i in range(S))   # unmasked (q, k)
    flops = 4 * d * H * B * pairs
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    lib = None
    if W == 0 or W >= S:          # the window does not bind: plain causal SDPA
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        try:
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
        except TypeError:         # a PyTorch without enable_gqa
            log("[kernels] scaled_dot_product_attention has no enable_gqa")
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:86",
        "launches": launches["flash_attention"],
        "max_abs_err": max_abs(flash_attention(q, k, v, True, W),
                               attention_ref(q, k, v, causal=True, window=W)),
        "ms": time_ms(lambda: flash_attention(q, k, v, True, W), reps=9, inner=3),
        "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True, window=W),
                            reps=9, inner=3),
        "device_ms": kernel_device_ms(lambda: flash_attention(q, k, v, True, W),
                                      "flash_fwd_kernel", n=5),
        "bound_ms": 1e3 * max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S),
        "bound_by": "operations" if flops / BF16_FLOPS_PER_S > nbytes / HBM_BYTES_PER_S
        else "bytes",
        "library_ms": lib, "shape": [B, S, H, K, d], "dtype": "bfloat16",
        "window": W})
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.kernels import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = gpu_line()
    name = torch.cuda.get_device_name(0)
    log(f"[device] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} device(s)")
    phase_build()
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    phase_rmsnorm(gen)
    phase_flash(gen)

    rng = np.random.RandomState(SEED)
    reset_launch_counts()                      # the main path: phases 5-6
    phase_model_f32(rng)
    cfg, params = phase_serve_bf16(rng)
    launches = launch_counts()
    log(f"[main path] kernel launches in phases 5-6: {launches}")
    for kname, n in launches.items():
        check(n > 0, f"kernel {kname} was not launched on the main path")
    phase_profile(cfg, params, rng)
    del params

    kernels = phase_kernels_line(cfg, launches, gen)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

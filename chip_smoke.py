#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

  python3 chip_smoke.py

It builds the hand-written kernels from the checkout's sources and
serves h2o-danube-1.8b (dense), mamba2-780m (ssm), hymba-1.5b (hybrid),
internvl2-1b (vision) and musicgen-medium (audio) at full width and full
depth, and arctic-480b and grok-1-314b (moe) at full width and reduced
depth (2 and 4 layers: neither fits one 80 GB card whole), trains
internvl2-1b at full size, trains h2o-danube-1.8b at full size through
the train launcher, plans a mesh through the KND core and trains
h2o-danube-1.8b at full size on it, trains mamba2-780m, hymba-1.5b,
internvl2-1b and musicgen-medium at full size and grok-1-314b at full
width and 1 layer on it, serves and trains h2o-danube-1.8b at
full size through the launchers' control-plane flags (a reconciled
replica set; a mesh the AttachmentController built, both with
``--obs-dir``), measures what the observability and control planes
cost h2o-danube-1.8b's host-bound serving, round-trips a full-width
checkpoint of the sharded state through the train launcher, re-plans an
elastic job after a node failure (gloo ranks on the CPU that shrink from
four to two; h2o-danube-1.8b at full width resuming on the card) and
serves h2o-danube-1.8b at full size on the legacy fixed-width engine,
and holds the dry run's roofline against the card, with random weights
from a seed, in phases (each logs its seconds):

  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc for the four CUDA libraries (RMSNorm, flash attention,
     paged attention, SSD chunk), all at once;
  3. RMSNorm kernel vs its plain version (f32, bf16 and f16 x; f32 and
     bf16 scales; contiguous and strided rows; every model width);
  4. flash-attention kernels vs their plain version (bf16 on tensor
     cores, f32 scalar; danube's, hymba's, arctic's, grok's, internvl2's
     and musicgen's shapes and others; a misaligned bf16 view) and the
     gradient;
  4b. SSD-chunk kernels (C.B^T once per chunk, then every head's block,
     3xTF32 on tensor cores) vs their plain version: the JAX tests'
     shapes and property-test shapes, model shapes, misaligned views
     (each also bit-equal to the kernels' output on an aligned copy);
  4c. paged decode-attention kernels (bf16 on tensor cores, f32 scalar)
     vs their plain version in f32, real rows only (padded rows zeros):
     danube-rag's ticks (64 slots of 4096 in shuffled 16-token blocks,
     chunks of 64 and of 1, clocks over 0-4032), few slots (the split
     over keys and its combine), hymba's, arctic's, internvl2's,
     musicgen's and the smoke configs' heads;
  5. danube in f32: prefill with the flash kernel vs the dense path,
     ServeEngine chunked-prefill first-token logits vs prefill, and a
     request's greedy tokens alone vs beside staggered others;
  6. danube serving in bf16 through the Router: 8 requests, 4 slots
     (every serving phase checks one paged-attention launch per layer
     and tick, and the dense path's count of phases 5-6 is checked
     exactly); then one decode_chunk tick at danube-rag's shape under
     torch.profiler: num_layers paged-attention kernels and no gather of
     the tables (``aten::index``); then a torch.profiler breakdown of its
     serving ticks;
  6b. plane cost: the same weights and load (8 requests of 64-512
     prompt tokens, 32 new, 4 slots, chunk 16) through the Router and
     ServeEngine under four arms, PLANE_COST_ROUNDS rounds rotating their
     order: A a disabled metrics registry and no tracer; B the live
     default registry and an installed tracer (what ``--obs-dir`` pays);
     C B and a 1-chip-per-slot replica set (``provision_replicas``) under
     the threaded informer, the tracer on its store; D C reconciled
     inline. Every run's greedy tokens equal; per arm the median, min and
     max of tokens/s, ms per tick and SloTracker's p50/p95 TTFT and TPOT,
     their ratios to A, and (first round) the device idle share of
     PROFILE_TICKS decode ticks;
  7. grok in f32 at 1 layer: prefill with the flash kernel vs the dense
     path and engine first-token logits vs prefill, on a prompt where
     neither drops an expert choice (both drop counts checked), staggered
     joins, and one moe_apply run twice, bit-equal;
  7b, 7c. grok (4 layers) and arctic (2 layers) serving in bf16 as in
     phase 6, each after a 2048-token prefill with its drop count; then
     the profile of arctic's serving ticks;
  10. hymba in f32: prefill with the flash and SSD kernels vs the dense
     attention path; 10b. hymba serving in bf16 as in phase 6;
  8. mamba2 in f32: one layer's ssd_apply on the card (kernel) vs the
     CPU (plain), ServeEngine first-token logits (sequential SSD
     decode) vs prefill (chunked, kernel), staggered joins, and a
     recycled slot vs fresh engines;
  9. mamba2 serving in bf16 through the Router: the mix of phase 6,
     after a checked 2048-token bf16 lm.prefill, a second one timed by
     CUDA events and a third under torch.profiler (the SSD kernels'
     share of its device time); then the profile of its serving ticks
     (last: after it the profiler recorded no kernel at all);
  12, 13. internvl2 (vision, behind 256 patch embeddings) and musicgen
     (audio, 4 codebooks) in f32 at 2 layers: prefill with the flash
     kernel vs the dense path, engine first-token logits vs prefill,
     staggered joins; 12b, 13b. each served in bf16 as in phase 6 (4
     requests), then the profile of its serving ticks;
  14. training in f32: one make_train_step step's gradients, internvl2
     at 2 layers with the flash kernel vs dense attention, and one
     hymba layer on the card (all three kernels, under remat none, dots
     and full) vs on the CPU; 14b. four bf16 steps of internvl2 at full
     size (AdamW, cosine schedule, remat full, 2 microbatches);
  15. the train launcher (``repro_torch.launch.train.main``) on
     h2o-danube-1.8b at full size: TRAIN_LAUNCH_STEPS steps of 8 x 64
     tokens, AdamW on the launcher's cosine schedule, remat dots, the
     flash kernel (the launcher's choice on the card), no checkpoint:
     completed steps, finite losses, peak memory;
  17. the mesh plan: the KND workflow (TPU and ICI driver discovery on a
     1 x 1 pod, a one-chip claim through the StructuredAllocator, an
     aligned data x model plan) and MeshRuntime.execute, which refuses
     without a process group and builds a 1 x 1 DeviceMesh on cuda over
     an NCCL group of world size 1 (destroyed at the end of the phase);
  18. mesh train: on that plan's mesh over a new NCCL group, RMSNorm and
     flash on DTensors at danube's shapes vs their plain versions, then
     h2o-danube-1.8b at full size through the Trainer, MESH_STEPS AdamW
     steps of 8 x 64 tokens, remat dots, the flash kernel, under
     use_rules(ShardingRules(mesh=...)) and then, the first state freed,
     without rules: every parameter a DTensor on cuda after the first,
     each step's loss and grad norm within 1e-4 relative between the two,
     each run's launches exact; ms per step (CUDA events) and peak
     memory of both;
  19. pod mean: compressed_pod_mean over the mesh run's gradient tree with
     one pod over NCCL: int8 in every SUM all_reduce, every mean bit-equal
     to the plain arithmetic, the new error within one quantisation step;
  22. mesh families: on phase 17's plan over a new NCCL group, the SSD
     chunk on DTensors (x over the batch and the heads, C and B over the
     batch) at mamba2's and hymba's prefill shapes vs its plain version,
     forward and gradient; then MESH_FAMILIES (mamba2, hymba, internvl2
     with its patch embeddings and musicgen at full size under AdamW;
     grok at full width and 1 layer under Adafactor, whose factored state
     leaves room for its 13.1 GB of gradients), MESH_FAMILY_STEPS steps
     of 8 x 64 tokens each, remat dots, the flash kernel, under
     use_rules(ShardingRules(mesh=...)) and then, the first state freed,
     without rules: every parameter a DTensor on cuda after the first,
     each step's loss and grad norm within 1e-4 relative between the two,
     each run's launches exact, grok's dropped choices equal; ms per step
     (CUDA events) and peak memory of both, beside the card's name and
     power limit;
  20. knd serve: danube at full size through the serve launcher, 4
     requests, plain and then with ``--claim-chips 1 --state-dir
     --node-plane`` (threaded informer): the workload Ready, one claim
     per slot, the replica named after it, the SLO published into
     ``outputs["slo"]``, every request's greedy tokens equal to the plain
     run's; that run also takes ``--obs-dir`` (under a fresh metrics
     registry): metrics.json counts every request admitted and completed,
     the engine's ticks and one TTFT per request, and the tracer's spans
     (the port's ``validate_spans``) hold one gap-free Request tree per
     request, each claim's lifecycle up to Prepared and the workload's up
     to Ready; a rerun with 3 slots adopts both claims byte-identical and
     stamps one (state and artifacts under build/, removed after);
  21. knd train: danube at full size through the train launcher, 2
     steps of 8 x 64, the flash kernel, without and with ``--mesh 1x1
     --devices 1 --state-dir --node-plane``: the ``[knd] MeshPlan``
     line, losses and grad norms within 1e-4; the meshed run's
     ``--obs-dir`` artifacts (the ``[obs] artifacts`` line, well-formed
     spans, the claim's lifecycle up to Prepared and the workload's up to
     Ready, a reconcile latency for both kinds); a rerun adopts the claim
     with its allocation unchanged;
  16. checkpoints of the sharded state: danube at full width and
     CKPT_LAYERS layers through the train launcher on the planned 1 x 1
     mesh, 5 steps, an async save at step 3 (every leaf a DTensor,
     gathered, written with the store co-checkpoint under build/,
     removed after); restored into the unsharded state here and by a
     ``--resume`` run into the sharded one, both bit-equal to the state
     saved, the resumed losses equal within 1e-6, ``store.json`` loading
     into a store with the saved fingerprint; logs the codec, bytes, the
     gather's, snapshot's, write's and both restores' seconds;
  23. elastic: (a) on this machine's CPU by design (one card holds one
     NCCL rank, so no card runs a mesh that shrinks), smoke danube in f32
     on four gloo ranks of the (4, 1) plan of a (x=1, y=4) pod until
     FaultInjector(fail_at=5) stops them, NODE_FAILED on the
     ElasticController's bus, two new gloo ranks on the re-planned (2, 1)
     mesh resuming the step-3 checkpoint: stop results, meshes, resumed
     step, losses within 1e-4 of the unsharded port; (b) on the card,
     danube at full width and ELASTIC_LAYERS layers under the controller
     (threaded informer, node plane) sharing the trainer's bus: the stop,
     the (2, 1) re-plan, the claim re-allocated and prepared, JOB_RESUMED
     once, a new Trainer resuming at step 3 whose steps 4-5 are bit-equal
     to an uninterrupted run's; NODE_FAILED to the re-planned Ready and
     the restore seconds (checkpoint at zlib level
     ELASTIC_COMPRESS_LEVEL);
  24. legacy serve: the legacy fixed-width engine on danube, in f32 at
     LEGACY_F32_LAYERS layers (first-token logits vs lm.prefill within
     2e-3) and in bf16 at full size: the recycled-slot contamination
     against the ServeEngine, ``submit([])`` raising IndexError at run
     time, ``run(max_steps=3)`` returning [], and tokens/s and ms per tick
     beside the ServeEngine's on the same prompts and slots (one run each
     at a toy load: logged, no claim); the ServeEngine's runs are a path
     of their own;
  25. dryrun card: the card's dense bf16 matmul rate and HBM bytes/s,
     each at or below the data sheet (the roofline's bound); the dry run
     (``repro_torch.launch.dryrun.lower_cell``) of danube's train_4k cell
     on a fake 16 x 16 process group on this machine's CPU, ok, with its
     roofline on the data sheet and at the measured rates; and danube
     at full width and DRYRUN_LAYERS layers, one AdamW step traced on
     fake tensors and run on the card under the same counter: matmul
     FLOPs equal, bytes within 2 %, the trace's peak within 10 % of
     max_memory_allocated, the step's profiled device time at least the
     roofline's bound;
  11. the kernels line: launches on the seventeen paths, in this order
     (phases 5-6, the dense path; 6b, plane cost; 7-7c, the moe path;
     10-10b, the hybrid
     path; 12-12b, vision; 13-13b, audio; 14-14b, train; 15, trainer;
     8-9, the ssm path; 17-19, mesh; 22, mesh families; 20, knd serve;
     21 and 16, knd train; 23, elastic; 24, legacy and legacy vs serve;
     25, dryrun),
     each path's counts
     set to 0 just before it
     (the mesh and mesh families paths: before each of their runs) and
     read just after and checked, and
     each kernel's time at its
     paths' shapes (taken after phase 4c) beside its plain version, a
     PyTorch library call computing the same function where there is
     one, its bound and its own device time, summed over every CUDA
     kernel its wrapper launches (a missing profiler record fails the
     run); for the SSD chunk also its kernels' registers and local
     memory as the CUDA runtime reports them, and mamba2's timed prefill.

Any failed check raises, so the exit code is non-zero and no result
line is printed. Without a CUDA device the script exits with code 1
before doing anything. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import contextlib
import gc
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
SSM_ARCH = "mamba2-780m"
HYBRID_ARCH = "hymba-1.5b"
# Neither MoE model fits one 80 GB card whole (bf16, by param_count:
# arctic 27.63 GB per layer + 0.92 outside the layers, grok 9.84 + 3.22),
# so both run at full width and reduced depth: ~56.2 and ~42.6 GB.
MOE_DEPTH = {"arctic-480b": 2, "grok-1-314b": 4}
MOE_F32_ARCH = "grok-1-314b"       # at 1 layer in f32: ~19.7 GB + 6.4 outside
VISION_ARCH = "internvl2-1b"
AUDIO_ARCH = "musicgen-medium"
FRONTEND_F32_LAYERS = 2            # the frontends' and the training f32 checks
TRAIN_STEPS = 4                    # internvl2-1b's bf16 steps at full size
TRAIN_LAUNCH_STEPS = 4             # the train launcher's steps, danube at full size
# the checkpoint phase: danube at full width and 1 layer (233.3 M
# parameters, 2.33 GB of state with AdamW's; cut for the script's time); a
# full-depth save is 18.3 GB through one compression thread
CKPT_LAYERS = 1
CKPT_EVERY, CKPT_FIT = 3, 5        # one save, at step 3, in a fit of 5 steps
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
KND_SERVE_DIR = os.path.join(ROOT, "build", "chip_smoke_knd_serve")   # state dirs
KND_TRAIN_DIR = os.path.join(ROOT, "build", "chip_smoke_knd_train")
KND_OBS_DIR = os.path.join(ROOT, "build", "chip_smoke_obs")   # --obs-dir artifacts
KND_REQUESTS = 4                   # the declarative serve path's requests
KND_STEPS = 2                      # the declarative train path's steps per run
MESH_STEPS = 3                     # danube's steps on the planned mesh, and without
# phase 23: elastic re-planning. (b) trains danube at full width and 1 of
# 24 layers on the card, its checkpoint written with zlib level 0 (stored:
# a save and a restore cost copies, not compression); (a) runs the gloo
# ranks on the CPU
ELASTIC_LAYERS = 1
ELASTIC_COMPRESS_LEVEL = 0
ELASTIC_FAIL_AT, ELASTIC_CKPT_EVERY = 5, 3
ELASTIC_DIR = os.path.join(ROOT, "build", "chip_smoke_elastic")
# phase 24: the legacy engine; its f32 check's depth, its baseline's requests
LEGACY_F32_LAYERS = 2
LEGACY_REQUESTS = 4
# phase 22: (arch, layers (None: all), optimizer), each MESH_FAMILY_STEPS
# steps on the planned mesh and as many without. grok at 1 layer is 6.53 B
# parameters: 13.1 GB in bf16 and as much again in gradients; AdamW's f32
# moments would add 52 GB, Adafactor's factored state a few MB
MESH_FAMILIES = (("mamba2-780m", None, "adamw"), ("hymba-1.5b", None, "adamw"),
                 ("internvl2-1b", None, "adamw"), ("musicgen-medium", None, "adamw"),
                 ("grok-1-314b", 1, "adafactor"))
MESH_FAMILY_STEPS = 2
FRONTEND_REQUESTS = 4              # the frontends' serving requests
# ticks per regime in each serving profile, timed and then profiled: few,
# for the script's time (a profiled mamba2 tick records ~30 k kernels),
# and enough, as device time per tick moves by under 2 % between runs
PROFILE_TICKS = 4
PLANE_COST_ARMS = "ABCD"           # [plane cost]: the arms, rotated one place per round
PLANE_COST_ROUNDS = 2                 # few, for the script's time
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core peak
F32_FLOPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12          # H100 SXM dense TF32 tensor-core peak
F32_TOL, BF16_TOL = 2e-5, 2e-2     # kernel vs plain, as tests/test_kernels.py
# flash vs its plain version in f32, per output row: the row's largest
# error over the row's RMS. Late rows average thousands of keys, so their
# outputs are ~0.03 and an absolute bound cannot see a fault confined to
# late KV tiles. f32: the scalar kernel only reorders f32 sums. bf16: the
# output's rounding is <= 2^-8 of an element, an element <= ~4x its row's
# RMS at d <= 128, and P's rounding adds ~2^-9.
FLASH_ROW_REL_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 5e-2}
SSD_TOL = 1e-4                     # SSD chunk vs plain, abs, as tests/test_kernels.py
# SSD chunk vs plain at model-like decays (da = dt * A, A down to -16),
# relative: cum reaches -1e3 at Q = 256, where an f32 cum_i - cum_j
# carries ~1e-4 relative noise between two summation orders.
SSD_REL_TOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def timed(name: str, fn, *args):
    """Run one phase and log its seconds."""
    t = time.perf_counter()
    out = fn(*args)
    log(f"[seconds] {name}: {time.perf_counter() - t:.1f}")
    return out


class DropCounter:
    """Counts the choices ``moe_apply`` drops while it is entered, through
    the routing helper ``moe_apply`` calls (one count per MoE layer call,
    kept on the device and summed on exit)."""

    def __enter__(self):
        from repro_torch.models import layers
        self._layers, self._route = layers, layers._route
        self._drops = []

        def route(cfg, p, xt, *real):
            r = self._route(cfg, p, xt, *real)
            self._drops.append((~r.keep).sum())
            self.cap = r.cap
            return r

        layers._route = route
        return self

    def __exit__(self, *exc):
        self._layers._route = self._route
        self.drops = int(sum(int(d) for d in self._drops))


def gpu_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def event_window(fn, inner: int) -> float:
    """ms per call of ``fn`` over one CUDA-event window of ``inner`` calls."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(inner):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / inner


def time_ms(fn, reps: int = 15, inner: int = 10) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` launches."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return statistics.median(event_window(fn, inner) for _ in range(reps))


def time_pair(fn, lib, rounds: int = 15, inner: int = 20) -> dict:
    """``fn`` against ``lib`` in alternating CUDA-event windows of
    ``inner`` calls (``fn`` first in even rounds, ``lib`` in odd): each
    one's median time per call and the per-round ratio fn/lib (median,
    least, most), so host noise that comes and goes hits both alike."""
    import torch
    for _ in range(5):
        fn()
        lib()
    torch.cuda.synchronize()
    ts, ls = [], []
    for r in range(rounds):
        if r % 2:
            ls.append(event_window(lib, inner))
            ts.append(event_window(fn, inner))
        else:
            ts.append(event_window(fn, inner))
            ls.append(event_window(lib, inner))
    ratios = [t / l for t, l in zip(ts, ls)]
    return {"ms": statistics.median(ts), "library_ms": statistics.median(ls),
            "ratio_median": statistics.median(ratios), "ratio_min": min(ratios),
            "ratio_max": max(ratios)}


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


def kernel_device_ms_by_name(fn, kernels, n: int = 20) -> dict:
    """Median device duration of each kernel in ``kernels`` (names) that
    one call of ``fn`` launches, over the launches torch.profiler
    recorded. The median of each kernel's own records, not a sum over
    the window divided by ``n``, so a record the profiler drops cannot
    shrink the time. The profiler on the card machine loses a contiguous
    run of records in a few percent of sessions (``prefill_timing``), so
    up to PROFILE_SESSIONS sessions are run and the first that recorded
    every kernel is read; raises when none did."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        us = {kernel: [e.device_time_total for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and kernel in e.name] for kernel in kernels}
        if all(us.values()):
            break
    missing = [k for k, v in us.items() if not v]
    check(not missing, f"torch.profiler recorded no device activity named {missing} "
                       f"in {PROFILE_SESSIONS} sessions")
    return {kernel: statistics.median(v) / 1e3 for kernel, v in us.items()}


def kernel_device_ms(fn, kernel: str, n: int = 20) -> float:
    """Median device duration of the one kernel named ``kernel`` that
    ``fn`` launches (:func:`kernel_device_ms_by_name`)."""
    return kernel_device_ms_by_name(fn, (kernel,), n)[kernel]


def device_kernels(fn) -> list:
    """Names of the kernels one call of ``fn`` launches, by torch.profiler,
    each cut to 80 characters: which kernel a library call chose."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [k[:80] for k, *_ in kernel_events(prof) if not k.startswith("Mem")]
    check(bool(names), "torch.profiler recorded no kernel of a library call")
    return names


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def row_rel_err(out, ref) -> float:
    """The worst row's largest error over that row's RMS in ``ref``."""
    err = (out.float() - ref.float()).abs().amax(-1)
    return float((err / ref.float().pow(2).mean(-1).sqrt()).max())


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.build import load_library
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.paged_attention import paged_attention as pa
    from repro_torch.kernels.rmsnorm import rmsnorm as rn
    from repro_torch.kernels.ssd_scan import ssd_scan

    def build(name, source):
        t = time.perf_counter()
        load_library(name, [source])
        return time.perf_counter() - t

    t0 = time.perf_counter()
    libs = (("rmsnorm", rn.SOURCE), ("flash_attention", fa.SOURCE),
            ("paged_attention", pa.SOURCE), ("ssd_chunk", ssd_scan.SOURCE))
    with ThreadPoolExecutor(len(libs)) as ex:  # one nvcc per source, together
        jobs = {name: ex.submit(build, name, src) for name, src in libs}
        secs = {name: job.result() for name, job in jobs.items()}
    log("[build] nvcc " + ", ".join(f"{k}: {v:.1f} s" for k, v in secs.items())
        + f" (in parallel: {time.perf_counter() - t0:.1f} s)")


def phase_rmsnorm(gen):
    """At every width the main paths give the kernel: danube's d_model
    2560, arctic's 7168 and grok's 6144, mamba2's d_model 1536 and
    d_inner 3072 (the gated norm), hymba's 1600 and 3200, internvl2's
    896 (musicgen's 1536 is mamba2's). Norm weights
    near their init value of 1. The plain version runs on
    the same inputs in f32 (its final cast left out): kernel and plain
    differ in the last f32 bit (reduction order, rsqrt), and two bf16
    roundings of such values can land one bf16 step (0.03 at |y| >= 4)
    apart; against the f32 value the kernel's error is its own rounding."""
    import torch
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    worst, n = {}, 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for D in (896, 1536, 1600, 2560, 3072, 3200, 6144, 7168):
            for rows in (1, 4, 64, 4096, 8192):
                x = torch.randn(rows, D, device=DEVICE, generator=gen).to(dtype)
                s = 1 + 0.1 * torch.randn(D, device=DEVICE, generator=gen)
                err = max_abs(rmsnorm(x, s), rmsnorm_ref(x.float(), s))
                check(err <= tol, f"rmsnorm rows={rows} D={D} {dtype}: {err} > {tol}")
                worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
                n += 1
    # the kernel's other dtypes: f16 x, and a bf16 scale (as the bf16
    # models hold their norm weights)
    for dtype, s_dtype, tol in ((torch.float16, torch.float32, BF16_TOL),
                                (torch.float16, torch.bfloat16, BF16_TOL),
                                (torch.bfloat16, torch.bfloat16, BF16_TOL),
                                (torch.float32, torch.bfloat16, F32_TOL)):
        for rows, D in ((4, 3072), (64, 2560), (8192, 1536)):
            x = torch.randn(rows, D, device=DEVICE, generator=gen).to(dtype)
            s = (1 + 0.1 * torch.randn(D, device=DEVICE, generator=gen)).to(s_dtype)
            err = max_abs(rmsnorm(x, s), rmsnorm_ref(x.float(), s))
            key = f"{dtype} x, {s_dtype} scale"
            check(err <= tol, f"rmsnorm rows={rows} D={D} {key}: {err} > {tol}")
            worst[key] = max(worst.get(key, 0.0), err)
            n += 1
    # strided rows: a column slice read in place by the vector path, one
    # that starts off a 16-byte boundary (the scalar path), and leading
    # dimensions that do not fold into rows (copied first)
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        base = torch.randn(4, 16, 3200, device=DEVICE, generator=gen).to(dtype)
        s = 1 + 0.1 * torch.randn(3072, device=DEVICE, generator=gen)
        for view, x in (("vector", base[..., :3072]), ("scalar", base[..., 1:3073]),
                        ("copied", base[..., :3072].transpose(0, 1))):
            err = max_abs(rmsnorm(x, s), rmsnorm_ref(x.float(), s))
            check(err <= tol, f"rmsnorm strided ({view}) {dtype}: {err} > {tol}")
            worst[str(dtype)] = max(worst[str(dtype)], err)
            n += 1
    log(f"[rmsnorm] {n} cases vs plain ok; max abs err {worst}")


def phase_flash(gen):
    """Both kernels (bf16 on tensor cores, f32 scalar) against the plain
    version; the bf16 kernel rounds P to bf16 for P.V, which the bf16
    tolerance covers."""
    import torch
    from repro_torch.kernels.cp_async import cp_async_ready
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    cases = []
    for d in (80, 128):
        for S in (200, 2048):
            for window in (0, 256, 4096):
                cases.append((2 if S == 200 else 1, S, 32, 8, d, True, window))
    cases += [(2, 200, 32, 8, 80, False, 0), (1, 333, 8, 2, 64, True, 100),
              (1, 2048, 25, 5, 64, True, 1024),    # hymba's prefill: 25/5 heads
              (1, 4096, 32, 8, 80, True, 4096),    # danube: the window binds at the end
              (1, 2048, 56, 8, 128, True, 0),      # arctic's prefill: group 7
              (1, 2048, 48, 8, 128, True, 0),      # grok's prefill: group 6
              (1, 2048, 14, 2, 64, True, 0),       # internvl2's prefill: group 7, d 64
              (1, 2048, 24, 24, 64, True, 0)]      # musicgen's prefill: group 1
    worst, worst_row = {}, {}
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        row_tol = FLASH_ROW_REL_TOL[str(dtype)]
        for B, S, H, K, d, causal, window in cases:
            q = torch.randn(B, S, H, d, device=DEVICE, generator=gen).to(dtype)
            k = torch.randn(B, S, K, d, device=DEVICE, generator=gen).to(dtype)
            v = torch.randn(B, S, K, d, device=DEVICE, generator=gen).to(dtype)
            out = flash_attention(q, k, v, causal, window)
            # the plain version in f32 on the same inputs; cast to the
            # inputs' dtype it is attention_ref(q, k, v) bit for bit
            ref = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                                window=window)
            what = f"flash B={B} S={S} H={H} K={K} d={d} causal={causal} window={window} {dtype}"
            err = max_abs(out, ref.to(dtype))
            check(err <= tol, f"{what}: {err} > {tol}")
            row = row_rel_err(out, ref)
            check(row <= row_tol, f"{what}: row error / row RMS {row} > {row_tol}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
            worst_row[str(dtype)] = max(worst_row.get(str(dtype), 0.0), row)
    # a bf16 q whose seq stride (644 elements) is not a multiple of 8: the
    # wrapper copies it for the kernel's 16-byte copies
    base = torch.randn(1, 300, 8 * 80 + 4, device=DEVICE, generator=gen).to(torch.bfloat16)
    q = base[..., :640].unflatten(-1, (8, 80))
    k, v = (torch.randn(1, 300, 2, 80, device=DEVICE, generator=gen).to(torch.bfloat16)
            for _ in range(2))
    check(not cp_async_ready(q), "the misaligned view passes the cp.async check")
    err = max_abs(flash_attention(q, k, v, True, 0), attention_ref(q, k, v))
    check(err <= BF16_TOL, f"flash misaligned bf16 view: {err} > {BF16_TOL}")
    worst["bf16 misaligned view"] = err
    # gradient of q through the autograd.Function vs the plain version's
    q, k, v = (torch.randn(1, 64, n, 64, device=DEVICE, generator=gen) for n in (4, 2, 2))
    q1 = q.clone().requires_grad_(True)
    flash_attention(q1, k, v).sum().backward()
    q2 = q.clone().requires_grad_(True)
    attention_ref(q2, k, v).sum().backward()
    gerr = max_abs(q1.grad, q2.grad)
    check(gerr <= 1e-4, f"flash dq: {gerr} > 1e-4")
    log(f"[flash] {2 * len(cases) + 1} cases vs plain ok; max abs err {worst}; "
        f"worst row error / row RMS {worst_row}; dq err {gerr:.3g}")


def ssd_inputs(gen, b, nc, Q, N, H, P, x_dtype, model_like, da_scale=0.1):
    """The distribution of tests/test_kernels.py (unit normals,
    dt = softplus(n), da = -|n| * da_scale: 0.1 in its fixed cases, 0.05
    in its property test) or, with ``model_like``, mamba2's init decays
    da = dt * A with A = -linspace(1, 16, H)."""
    import torch
    import torch.nn.functional as F
    C = torch.randn(b, nc, Q, N, device=DEVICE, generator=gen)
    B = torch.randn(b, nc, Q, N, device=DEVICE, generator=gen)
    x = torch.randn(b, nc, Q, H, P, device=DEVICE, generator=gen).to(x_dtype)
    dt = F.softplus(torch.randn(b, nc, Q, H, device=DEVICE, generator=gen))
    if model_like:
        da = dt * -torch.linspace(1.0, 16.0, H, device=DEVICE)
    else:
        da = -torch.randn(b, nc, Q, H, device=DEVICE, generator=gen).abs() * da_scale
    return C, B, x, dt, da


def ssd_errs(out, ref):
    """(max abs error, max of each output's error over its own largest
    magnitude) over y_diag, states and decays."""
    ab = max(max_abs(o, r) for o, r in zip(out, ref))
    rel = max(max_abs(o, r) / max(float(r.abs().max()), 1e-30) for o, r in zip(out, ref))
    return ab, rel


def phase_ssd(gen):
    import torch
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    from repro_torch.kernels.cp_async import cp_async_ready
    # the JAX tests' shapes and distribution, at their abs bound
    test_cases = [(2, 3, 16, 8, 4, 16), (1, 2, 32, 16, 2, 8), (1, 1, 64, 32, 3, 16)]
    # the JAX property test's shapes (b 1, nc 2, H 2, da scale 0.05): N 4
    # and 8, P 8 and 16 are padded to 16 inside the kernel
    prop_cases = [(1, 2, Q, N, 2, P) for Q in (8, 16, 32) for N in (4, 8) for P in (8, 16)]
    # mamba2 (Q = 256, and 100 for a 100-token prompt) and hymba, at their
    # init's decays, at a relative bound
    model_cases = [(1, 2, 256, 128, 48, 64), (1, 1, 100, 128, 48, 64),
                   (1, 2, 256, 16, 50, 64)]
    worst = {}
    for x_dtype in (torch.float32, torch.bfloat16):
        for model_like, cases in ((False, test_cases), (True, model_cases)):
            for shape in cases:
                ins = ssd_inputs(gen, *shape, x_dtype, model_like)
                out = ssd_chunk(*ins)
                ab, rel = ssd_errs(out, ssd_chunk_ref(*ins))
                if model_like:
                    check(rel <= SSD_REL_TOL, f"ssd {shape} {x_dtype} model-like: "
                                              f"rel err {rel} > {SSD_REL_TOL}")
                else:
                    check(ab <= SSD_TOL, f"ssd {shape} {x_dtype}: {ab} > {SSD_TOL}")
                key = f"{x_dtype} {'model-like rel' if model_like else 'test abs'}"
                worst[key] = max(worst.get(key, 0.0), rel if model_like else ab)
        for shape in prop_cases:
            ins = ssd_inputs(gen, *shape, x_dtype, False, da_scale=0.05)
            ab, _ = ssd_errs(ssd_chunk(*ins), ssd_chunk_ref(*ins))
            check(ab <= SSD_TOL, f"ssd property shape {shape} {x_dtype}: {ab} > {SSD_TOL}")
            key = f"{x_dtype} property abs"
            worst[key] = max(worst.get(key, 0.0), ab)
    # a bf16 x whose token stride (H * P + 4 elements) is off the 16-byte
    # grid: the wrapper copies it for the kernels' 16-byte copies, so the
    # output must be bit-equal to the output on an aligned contiguous copy
    # of x. At a JAX test's shape (abs bound), at mamba2's with its init's
    # decays (rel bound) and at mamba2's with the JAX tests' distribution
    # (rel bound: the JAX tests stop at Q = 64, and at Q = 256 that
    # distribution's outputs reach ~3e2, where an abs 1e-4 is about 2^-21 of them)
    for (b, nc, Q, N, H, P), model_like, rel_bound in (
            ((1, 2, 64, 32, 4, 16), False, False), ((1, 2, 256, 128, 8, 64), True, True),
            ((1, 2, 256, 128, 8, 64), False, True)):
        C, B, _, dt, da = ssd_inputs(gen, b, nc, Q, N, H, P, torch.float32, model_like)
        base = torch.randn(b, nc * Q, H * P + 4, device=DEVICE,
                           generator=gen).to(torch.bfloat16)
        x = base[..., :H * P].reshape(b, nc, Q, H, P)
        check(not cp_async_ready(x), "the misaligned x view passes the cp.async check")
        xc = x.contiguous()
        check(cp_async_ready(xc), "the contiguous copy fails the cp.async check")
        out = ssd_chunk(C, B, x, dt, da)
        check(all(torch.equal(o, a) for o, a in zip(out, ssd_chunk(C, B, xc, dt, da))),
              f"ssd misaligned bf16 x view, Q {Q}: output differs from the aligned copy's")
        ab, rel = ssd_errs(out, ssd_chunk_ref(C, B, x, dt, da))
        key = f"bf16 misaligned x view, Q {Q}, {'model-like' if model_like else 'test'}"
        if rel_bound:
            check(rel <= SSD_REL_TOL, f"ssd {key}: rel err {rel} > {SSD_REL_TOL}")
            worst[key + " rel"] = rel
        else:
            check(ab <= SSD_TOL, f"ssd {key}: {ab} > {SSD_TOL}")
            worst[key + " abs"] = ab
    n = 2 * (len(test_cases) + len(model_cases) + len(prop_cases)) + 3
    log(f"[ssd] {n} cases vs plain ok; max err {worst}")


# danube-rag's engine: 64 slots of max_len 4096 in blocks of 16, chunks of 64
PAGED_SLOTS, PAGED_CHUNK, PAGED_BLOCK, PAGED_MAX_LEN = 64, 64, 16, 4096


def paged_slots(rng, B, C, mix="spread"):
    """Block tables, clocks and real tokens of B slots -> (table (B, nb),
    pos, adv) as numpy int32: tables of PAGED_MAX_LEN // PAGED_BLOCK
    shuffled blocks of a pool of B nb + 1, the unused entries on the zero
    sentinel block 0. ``mix`` "spread": clocks evenly over 0-4032 in a
    shuffled order, each slot a decode row, a whole or partial chunk or
    nothing (slot 0 at least a decode row); "rag": danube-rag's tick, 34
    slots prefilling whole chunks beside decode rows (a padded-row share
    of ~0.46 at 64 slots), clocks uniform in 0-3000 (mean ~1500
    resident); at C = 1 every slot decodes."""
    import numpy as np
    nb = PAGED_MAX_LEN // PAGED_BLOCK
    if mix == "rag":
        adv = [C] * 34 + [1] * (B - 34) if C > 1 else [1] * B
        pos = rng.randint(0, min(3001, PAGED_MAX_LEN - C + 1), size=B)
    else:
        adv = [int(rng.choice([0, 1, C, rng.randint(1, C + 1)])) if C > 1
               else int(rng.randint(0, 2)) for _ in range(B)]
        adv[0] = max(adv[0], 1)                    # at least one real row
        pos = rng.permutation(np.linspace(0, PAGED_MAX_LEN - 64, B).astype(int))
    perm = rng.permutation(np.arange(1, B * nb + 1))
    table = np.zeros((B, nb), np.int32)
    for b in range(B):
        used = -(-(int(pos[b]) + adv[b]) // PAGED_BLOCK)
        table[b, :used] = perm[b * nb:b * nb + used]
    return table, np.asarray(pos, np.int32), np.asarray(adv, np.int32)


def paged_tick(gen, rng, cfg, B, C, dtype, mix="spread"):
    """One tick's inputs of the paged attention for ``cfg``'s heads
    (:func:`paged_slots`; random pool, q and the chunk's k, v of width C)
    -> the arguments of ``paged_attention``."""
    import torch
    H, K, d = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    table, pos, adv = paged_slots(rng, B, C, mix)
    NB = table.size + 1
    pool_k, pool_v = (torch.randn(NB, PAGED_BLOCK, K, d, device=DEVICE,
                                  generator=gen).to(dtype) for _ in range(2))
    pool_k[0] = 0
    pool_v[0] = 0
    q = torch.randn(B, C, H, d, device=DEVICE, generator=gen).to(dtype)
    k, v = (torch.randn(B, C, K, d, device=DEVICE, generator=gen).to(dtype) for _ in range(2))
    return (q, k, v, pool_k, pool_v,
            *(torch.from_numpy(a).to(DEVICE) for a in (table, pos, adv)))


def paged_errs(out, ref, adv):
    """The real rows' (j < adv) largest error and largest error over the
    row's RMS in ``ref``; checks that every other row is zeros."""
    import torch
    real = torch.arange(out.shape[1], device=out.device)[None, :] < adv[:, None]
    if (~real).any():
        check(float(out[~real].float().abs().max()) == 0, "a padded row is not zeros")
    err = (out.float() - ref.float()).abs().amax(-1)[real]
    rms = ref.float().pow(2).mean(-1).sqrt()[real]
    return float(err.max()), float((err / rms).max())


def phase_paged(gen):
    """The paged decode-attention kernels (bf16 on tensor cores, f32
    scalar) against the plain version in f32 on the same inputs, real rows
    only: danube-rag's ticks (64 slots, chunks of 64 and of 1, clocks over
    0-4032), few slots (the split over keys and its combine), and the
    heads of hymba (group 5, window 1024), arctic (group 7, d 128),
    internvl2 (group 7, d 64), musicgen (group 1) and the smoke configs
    (d 16). Tolerances as flash's: P is rounded to bf16 for P.V."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config, smoke_config
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    rng = np.random.RandomState(SEED)
    danube = get_config(ARCH)
    cases = [(danube, PAGED_SLOTS, PAGED_CHUNK), (danube, PAGED_SLOTS, 1),
             (danube, 4, PAGED_CHUNK), (danube, 2, 1)]
    cases += [(get_config(a), 8, 16) for a in (HYBRID_ARCH, "arctic-480b", VISION_ARCH,
                                                AUDIO_ARCH)]
    cases.append((smoke_config(ARCH), 8, 16))
    worst, worst_row = {}, {}
    for dtype, tol in ((torch.bfloat16, BF16_TOL), (torch.float32, F32_TOL)):
        row_tol = FLASH_ROW_REL_TOL[str(dtype)]
        for cfg, B, C in cases:
            args = paged_tick(gen, rng, cfg, B, C, dtype)
            out = paged_attention(*args, window=cfg.sliding_window)
            ref = paged_attention_ref(*(t.float() if t.is_floating_point() else t
                                        for t in args), window=cfg.sliding_window)
            err, row = paged_errs(out, ref, args[-1])
            what = (f"paged {cfg.name} B={B} C={C} H={cfg.num_heads} K={cfg.num_kv_heads} "
                    f"d={cfg.resolved_head_dim} window={cfg.sliding_window} {dtype}")
            check(err <= tol, f"{what}: {err} > {tol}")
            check(row <= row_tol, f"{what}: row error / row RMS {row} > {row_tol}")
            worst[str(dtype)] = max(worst.get(str(dtype), 0.0), err)
            worst_row[str(dtype)] = max(worst_row.get(str(dtype), 0.0), row)
            del args, out, ref
    # the plain version in bf16 (the path the kernel replaced) against the
    # same f32 yardstick at danube-rag's prefill tick
    args = paged_tick(gen, rng, danube, PAGED_SLOTS, PAGED_CHUNK, torch.bfloat16)
    ref = paged_attention_ref(*(t.float() if t.is_floating_point() else t for t in args),
                              window=danube.sliding_window)
    plain = paged_attention_ref(*args, window=danube.sliding_window)
    real = torch.arange(PAGED_CHUNK, device=DEVICE)[None, :] < args[-1][:, None]
    plain_err = float((plain.float() - ref).abs().amax(-1)[real].max())
    del args, ref, plain
    torch.cuda.empty_cache()
    log(f"[paged] {2 * len(cases)} cases vs plain ok; max abs err {worst}; worst row "
        f"error / row RMS {worst_row}; the plain bf16 version's own max abs err at "
        f"danube-rag's prefill tick {plain_err:.3g}")


def phase_paged_tick(cfg, params):
    """One decode_chunk tick of ``cfg`` (danube at full size) at
    danube-rag's prefill mix on its engine's pool, under torch.profiler:
    exactly num_layers paged-attention kernels, and no gather of the
    tables (``aten::index``, what the plain version gathers with)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    rng = np.random.RandomState(SEED)
    B, C, nb = PAGED_SLOTS, PAGED_CHUNK, PAGED_MAX_LEN // PAGED_BLOCK
    cache = lm.init_paged_cache(cfg, B, B * nb + 1, PAGED_BLOCK, DEVICE)
    table, pos, adv = (torch.from_numpy(a).to(DEVICE) for a in paged_slots(rng, B, C, "rag"))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=(B, C))).to(DEVICE)

    def tick():
        return lm.decode_chunk(cfg, params, toks, cache, table, pos, adv)

    with torch.no_grad():
        tick()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tick()
            torch.cuda.synchronize()
    evs = kernel_events(prof)
    paged = sum(c for k, c, _ in evs if "paged_mma_kernel" in k)
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CPU}
    check(paged == cfg.num_layers,
          f"a {cfg.name} tick ran {paged} paged-attention kernels, not {cfg.num_layers}")
    check("aten::index" not in ops, f"a {cfg.name} tick gathers: aten::index x "
                                    f"{ops.get('aten::index')}")
    paged_ms = sum(us for k, _, us in evs if "paged" in k) / 1e3
    busy_ms = sum(us for *_, us in evs) / 1e3
    log(f"[paged tick] {cfg.name} {B} slots x chunk {C} (34 prefilling, 30 decoding): "
        f"{paged} paged-attention kernels ({paged_ms:.3f} ms of {busy_ms:.3f} ms device "
        f"time), no aten::index; index ops {sorted(k for k in ops if 'index' in k)}")
    del cache
    torch.cuda.empty_cache()


def capture_logits(engine, sink, widths=None):
    """Wrap the engine's decode step so each tick's logits land in
    ``sink`` (and each tick's chunk width C in ``widths``)."""
    step = engine._step

    def wrapped(params, tokens, *args, **kw):
        logits, cache = step(params, tokens, *args, **kw)
        sink.append(logits)
        if widths is not None:
            widths.append(tokens.shape[1])
        return logits, cache

    engine._step = wrapped


def norms_per_tick(cfg, C):
    """RMSNorm launches of one decode_chunk tick of width C: norm1 (and
    norm2) per layer, the gated norm once per token of each SSD step,
    and the final norm."""
    if cfg.family == "ssm":
        return cfg.num_layers * (1 + C) + 1
    if cfg.family == "hybrid":
        return cfg.num_layers * (2 + C) + 1
    return 2 * cfg.num_layers + 1


def paged_per_tick(cfg):
    """Paged-attention launches of one decode_chunk tick: one per layer,
    none for the attention-free ssm family."""
    return 0 if cfg.family == "ssm" else cfg.num_layers


def engine_first_token(cfg, params, prompt, lk, chunk):
    """ServeEngine chunked-prefill first-token logits vs ``lk``, the
    last-position logits of lm.prefill on the same prompt (for the audio
    family on the prompt broadcast to every codebook, as the engine feeds
    it; all codebooks compared, codebook 0 sampled). Returns the relative
    error and the engine's ticks."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    S = len(prompt)
    eng = ServeEngine(cfg, params, batch_slots=2, max_len=S + 16,
                      prefill_chunk=chunk, device=DEVICE, seed=SEED)
    seen = []
    capture_logits(eng, seen)
    r = eng.submit(prompt, max_new_tokens=4)
    with torch.no_grad():
        eng.run()
    check(r.done, "engine request did not complete")
    first = seen[math.ceil(S / chunk) - 1][0, (S - 1) % chunk]
    err = rel_err(first, lk[0, 0])
    check(err <= 2e-3, f"{cfg.name} engine first-token logits vs prefill: "
                       f"rel err {err} > 2e-3")
    sampled = lk[0, 0, 0] if cfg.frontend == "audio" else lk[0, 0]
    check(r.generated[0] == int(sampled.argmax()), "first greedy token differs")
    return err, eng.steps


def staggered_tokens_equal(cfg, params, rng):
    """A request's greedy tokens alone == beside staggered others.
    Returns the number of tokens compared and both engines' ticks."""
    import torch
    from repro_torch.serve.engine import ServeEngine
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
          f"{cfg.name}: staggered joins changed greedy tokens: "
          f"{ra.generated} vs {rb.generated}")
    return len(ra.generated), solo.steps + mixed.steps


def phase_model_f32(rng):
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
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
    e2, ticks = engine_first_token(cfg, params, prompt, lk, 128)
    n, ticks2 = staggered_tokens_equal(cfg, params, rng)
    log(f"[model f32] {cfg.num_layers} layers d_model {cfg.d_model}: prefill kernel "
        f"vs dense rel err {e1:.3g}; engine first-token vs prefill rel err {e2:.3g}; "
        f"staggered greedy tokens equal ({n})")
    del params
    torch.cuda.empty_cache()
    return ticks + ticks2


def phase_ssm_f32(rng):
    """mamba2 at full width and depth in f32."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers, lm
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(SSM_ARCH).replace(param_dtype="float32", compute_dtype="float32")
    params = lm.init_params(cfg, SEED, DEVICE)

    # one layer's ssd_apply: the card (kernel) vs the CPU (plain), S = 2048
    S = 2048
    toks = torch.tensor([rng.randint(0, cfg.vocab_size, size=S).tolist()],
                        device=DEVICE)
    lp = tree_map(lambda a: a[0], params["layers"])
    with torch.no_grad():
        x, _ = lm.embed_tokens(cfg, params, {"tokens": toks})
        h = layers.rmsnorm(lp["norm1"], x, cfg.norm_eps)
        yk, stk = layers.ssd_apply(cfg, lp["ssd"], h, return_state=True)
        yp, stp = layers.ssd_apply(cfg, tree_map(lambda a: a.cpu(), lp["ssd"]),
                                   h.cpu(), return_state=True)
    e_layer = max(rel_err(yk.cpu(), yp), rel_err(stk["state"].cpu(), stp["state"]))
    check(e_layer <= 1e-3, f"mamba2 layer 0 ssd_apply card vs CPU: rel err "
                           f"{e_layer} > 1e-3")

    # ServeEngine (sequential SSD decode) vs lm.prefill (chunked, kernel);
    # 1000 tokens: 4 chunks of 256, the last one padded
    prompt = rng.randint(0, cfg.vocab_size, size=1000).tolist()
    with torch.no_grad():
        lk, _ = lm.prefill(cfg, params, {"tokens": torch.tensor([prompt], device=DEVICE)})
    check(bool(torch.isfinite(lk).all()), "mamba2 f32 prefill logits not finite")
    e_eng, _ = engine_first_token(cfg, params, prompt, lk, 128)
    n, _ = staggered_tokens_equal(cfg, params, rng)

    # two requests through one recycled slot == two fresh engines
    pa, pb = (rng.randint(0, cfg.vocab_size, size=k).tolist() for k in (40, 60))

    def serve(*prompts):
        eng = ServeEngine(cfg, params, batch_slots=1, max_len=128, prefill_chunk=16,
                          device=DEVICE, seed=SEED)
        reqs = [eng.submit(p_, max_new_tokens=8) for p_ in prompts]
        with torch.no_grad():
            eng.run()
        check(all(r.done for r in reqs), "recycled-slot request did not complete")
        return [r.generated for r in reqs]

    recycled = serve(pa, pb)
    fresh = serve(pa) + serve(pb)
    check(recycled == fresh, f"recycled slot differs from fresh engines: "
                             f"{recycled} vs {fresh}")
    log(f"[ssm f32] {cfg.name} {cfg.num_layers} layers d_model {cfg.d_model}: layer-0 "
        f"ssd_apply card vs CPU rel err {e_layer:.3g}; engine first-token (sequential "
        f"decode) vs prefill (kernel) rel err {e_eng:.3g}; staggered greedy tokens "
        f"equal ({n}); recycled slot == fresh engines ({len(recycled[1])} tokens)")
    del params
    torch.cuda.empty_cache()


def phase_hybrid_f32(rng):
    """hymba at full width and depth in f32: lm.prefill with the flash
    and SSD kernels vs the dense attention path (whose SSD layers run
    the SSD kernel too) on a 2048-token prompt, where the window of
    1024 binds. The kernel prefill's launches are read around it alone,
    checked and returned."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import lm
    cfg = get_config(HYBRID_ARCH).replace(param_dtype="float32", compute_dtype="float32")
    params = lm.init_params(cfg, SEED, DEVICE)
    toks = torch.tensor([rng.randint(0, cfg.vocab_size, size=2048).tolist()],
                        device=DEVICE)
    with torch.no_grad():
        before = launch_counts()
        lk, _ = lm.prefill(cfg, params, {"tokens": toks}, attention_impl="kernel")
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        ld, _ = lm.prefill(cfg, params, {"tokens": toks}, attention_impl="dense")
    e_h = rel_err(lk, ld)
    check(bool(torch.isfinite(lk).all()) and e_h <= 1e-3,
          f"hymba prefill kernel vs dense: rel err {e_h} > 1e-3")
    # per layer: norm1 for the cache's K/V, norm1, the gated norm and
    # norm2 in the layer body; then the final norm
    L = cfg.num_layers
    want = {"flash_attention": L, "paged_attention": 0, "ssd_chunk": L, "rmsnorm": 4 * L + 1}
    check(counts == want, f"hymba kernel prefill launches {counts} != {want}")
    log(f"[hybrid f32] {cfg.name} {L} layers (full depth) d_model {cfg.d_model}, "
        f"2048-token prompt, window {cfg.sliding_window}: prefill with the flash and "
        f"SSD kernels vs dense attention rel err {e_h:.3g}; kernel prefill "
        f"launches {counts}")
    del params
    torch.cuda.empty_cache()
    return counts


def kernel_prefill_launches(cfg, n: int = 1) -> dict:
    """Launches of ``n`` lm.prefill calls with the flash kernel, dense
    and moe families: flash once per layer; RMSNorm for norm1 twice per
    layer (once for the cache's K/V, once in the layer body), norm2,
    and the final norm."""
    L = cfg.num_layers
    return {"flash_attention": n * L,
            "paged_attention": 0, "ssd_chunk": 0, "rmsnorm": n * (3 * L + 1)}


def add_launches(*counts) -> dict:
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def phase_moe_f32(rng):
    """grok-1-314b at full width and 1 layer in f32: lm.prefill with the
    flash kernel vs the dense attention path, and the ServeEngine's
    chunked-prefill first-token logits vs lm.prefill, on the first seeded
    512-token prompt whose prefill drops nothing (cap 256 per expert,
    twice the mean load), with both drop counts checked; greedy tokens
    alone vs beside staggered joins; one layer's moe_apply run twice on
    one input, bit-equal (a scatter by atomics would not be). Returns the
    kernel launches these calls make, from their structure."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import layers, lm
    cfg = get_config(MOE_F32_ARCH).replace(num_layers=1, param_dtype="float32",
                                           compute_dtype="float32")
    params = lm.init_params(cfg, SEED, DEVICE)
    S, prefills = 512, 0
    with torch.no_grad():
        for _ in range(4):
            prompt = rng.randint(0, cfg.vocab_size, size=S).tolist()
            toks = torch.tensor([prompt], device=DEVICE)
            with DropCounter() as dk:
                lk, _ = lm.prefill(cfg, params, {"tokens": toks}, attention_impl="kernel")
            prefills += 1
            if dk.drops == 0:
                break
        with DropCounter() as dd:
            ld, _ = lm.prefill(cfg, params, {"tokens": toks}, attention_impl="dense")
    check(dk.drops == 0 and dd.drops == 0,
          f"{cfg.name} f32 prefill drops {dk.drops} (kernel), {dd.drops} (dense)")
    e1 = rel_err(lk, ld)
    check(bool(torch.isfinite(lk).all()) and e1 <= 1e-3,
          f"{cfg.name} prefill kernel vs dense: rel err {e1} > 1e-3")
    # 2 slots x chunk 64 = 128 rows a tick: a token's k experts are
    # distinct, so no expert gets more than 128 choices, the capacity floor
    with DropCounter() as de:
        e2, ticks = engine_first_token(cfg, params, prompt, lk, 64)
    check(de.drops == 0, f"{cfg.name} engine dropped {de.drops} choices")
    # 4 slots x chunk 16 = 64 rows a tick, 128 choices, and no expert gets
    # more than 64 of them (a token's k experts are distinct): under the
    # capacity floor of 128, serving drops nothing, so no slot's rows can
    # push another slot's choices out of an expert
    n, ticks2 = staggered_tokens_equal(cfg, params, rng)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = torch.randn(1, 2048, cfg.d_model, device=DEVICE, generator=gen)
    lp = tree_map(lambda a: a[0], params["layers"])
    with torch.no_grad():
        y1, a1 = layers.moe_apply(cfg, lp["moe"], x)
        y2, a2 = layers.moe_apply(cfg, lp["moe"], x)
    check(torch.equal(y1, y2) and all(torch.equal(a1[k], a2[k]) for k in a1),
          f"{cfg.name} moe_apply differs between two runs on one input")
    log(f"[moe f32] {cfg.name} {cfg.num_layers} layer (of {get_config(MOE_F32_ARCH).num_layers}) "
        f"d_model {cfg.d_model}, {cfg.num_experts} experts top-{cfg.top_k}: {S}-token "
        f"prompt (try {prefills}), drops kernel {dk.drops} dense {dd.drops} engine "
        f"{de.drops} (cap {dk.cap} prefill, {de.cap} per engine tick); prefill kernel vs "
        f"dense rel err {e1:.3g}; engine first-token vs prefill rel err {e2:.3g}; "
        f"staggered greedy tokens equal ({n}); moe_apply at T=2048 (cap "
        f"{layers.moe_capacity(cfg, 2048)}) bit-equal over two runs")
    want = add_launches(kernel_prefill_launches(cfg, prefills),
                        {"flash_attention": 0,
                         "paged_attention": (ticks + ticks2) * paged_per_tick(cfg),
                         "ssd_chunk": 0,
                         "rmsnorm": 3 * cfg.num_layers + 1 + (ticks + ticks2)
                         * norms_per_tick(cfg, 1)})
    del params, lp
    torch.cuda.empty_cache()
    return want


def phase_frontend_f32(rng, arch):
    """internvl2-1b (vision) or musicgen-medium (audio) at full width and
    FRONTEND_F32_LAYERS layers in f32: lm.prefill with the flash kernel vs
    the dense attention path on a 512-token prompt (vision behind 256
    random patch embeddings, 768 positions; audio on random codes of 4
    codebooks); the ServeEngine's chunked-prefill first-token logits vs
    lm.prefill on the text alone (audio: the prompt broadcast to every
    codebook, as the engine feeds it); greedy tokens alone vs beside
    staggered joins. Returns the kernel launches these calls make, from
    their structure."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    cfg = get_config(arch).replace(num_layers=FRONTEND_F32_LAYERS, param_dtype="float32",
                                   compute_dtype="float32")
    params = lm.init_params(cfg, SEED, DEVICE)
    S = 512
    batch = prompt_batch(cfg, rng, S)
    prompt = rng.randint(0, cfg.vocab_size, size=S).tolist()
    text = torch.tensor([prompt], device=DEVICE)
    if cfg.frontend == "audio":
        text = text[..., None].expand(1, S, cfg.num_codebooks)
    with torch.no_grad():
        lk, ck = lm.prefill(cfg, params, batch, attention_impl="kernel")
        ld, _ = lm.prefill(cfg, params, batch, attention_impl="dense")
        lt, _ = lm.prefill(cfg, params, {"tokens": text}, attention_impl="kernel")
    e1 = rel_err(lk, ld)
    check(bool(torch.isfinite(lk).all()) and e1 <= 1e-3,
          f"{cfg.name} prefill kernel vs dense: rel err {e1} > 1e-3")
    n_pos = S + (cfg.num_patches if cfg.frontend == "vision" else 0)
    check(int(ck["pos"][0]) == n_pos,
          f"{cfg.name} prefill clock {int(ck['pos'][0])} != {n_pos}")
    e2, ticks = engine_first_token(cfg, params, prompt, lt, 128)
    n, ticks2 = staggered_tokens_equal(cfg, params, rng)
    log(f"[{cfg.frontend} f32] {cfg.name} {cfg.num_layers} of "
        f"{get_config(arch).num_layers} layers, d_model {cfg.d_model}, heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads} of {cfg.resolved_head_dim}, vocab "
        f"{cfg.vocab_size}: prefill over {n_pos} positions, kernel vs dense rel err "
        f"{e1:.3g}; engine first-token vs prefill rel err {e2:.3g}; staggered greedy "
        f"tokens equal ({n})")
    # flash in the two kernel prefills; 3L+1 RMSNorm in each of the three
    # prefills (kernel_prefill_launches) and 2L+1 per engine tick
    L = cfg.num_layers
    want = {"flash_attention": 2 * L,
            "paged_attention": (ticks + ticks2) * paged_per_tick(cfg), "ssd_chunk": 0,
            "rmsnorm": 3 * (3 * L + 1) + (ticks + ticks2) * norms_per_tick(cfg, 1)}
    del params
    torch.cuda.empty_cache()
    return want


def leaves_by_path(tree, prefix=""):
    """{"a/b/c": leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaves_by_path(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def device_batch(batch):
    """A numpy batch (SyntheticLMData's) as tensors on the card."""
    import torch
    return {k: torch.from_numpy(v).to(DEVICE) for k, v in batch.items()}


def train_grads(cfg, optimizer, state, batch, **step_kw):
    """One make_train_step step of ``state`` on ``batch``: the gradients
    its ``grad_transform`` hook is handed (averaged, before clipping) and
    the step's metrics. ``state`` itself is not changed."""
    from repro_torch.train.train_step import StepConfig, make_train_step
    seen = []

    def keep(grads):
        seen.append(grads)
        return grads

    _, metrics = make_train_step(cfg, optimizer, StepConfig(**step_kw), keep)(state, batch)
    return seen[0], metrics


def check_grads(got, want, what) -> float:
    """Every leaf of ``got`` present, finite and not all zero, and within
    1e-3 of that leaf's largest |g| in ``want``. Returns the worst ratio."""
    import torch
    got, want = leaves_by_path(got), leaves_by_path(want)
    check(sorted(got) == sorted(want), f"{what}: grad leaves {sorted(got)} != {sorted(want)}")
    worst = 0.0
    for name, w in want.items():
        g = got[name]
        check(g is not None and bool(torch.isfinite(g).all()),
              f"{what}: {name}: grad missing or not finite")
        scale = float(w.float().abs().max())
        check(scale > 0 and float(g.float().abs().max()) > 0, f"{what}: {name}: grad all zero")
        ratio = float((g.float().cpu() - w.float().cpu()).abs().max()) / scale
        check(ratio <= 1e-3, f"{what}: {name}: max abs err {ratio:.3g} of max |g| > 1e-3")
        worst = max(worst, ratio)
    return worst


def phase_train_f32():
    """Training in f32, the gradients of one make_train_step step:

    * internvl2-1b at full width and 2 layers, AdamW, remat "full", a
      batch of 2 x (256 patch embeddings + 256 tokens) from the port's
      SyntheticLMData: the flash kernel's step vs the dense attention
      path's, both on the card;
    * hymba-1.5b at full width and 1 layer, S = 512, on the card (flash,
      SSD and RMSNorm kernels under their autograd wrappers) under remat
      none, dots and full vs the step on the CPU (the plain versions).

    Loss within 1e-3 relative; every gradient leaf present, not all zero
    and within 1e-3 of its largest magnitude. Returns the launches, from
    the structure: per layer body one flash (and SSD) launch and its
    norms, twice under remat (the recompute reruns the forward), and
    the final norm once."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import constant_schedule
    from repro_torch.train.train_step import init_train_state
    opt = AdamW(constant_schedule(1e-4))

    vcfg = get_config(VISION_ARCH).replace(num_layers=FRONTEND_F32_LAYERS,
                                           param_dtype="float32", compute_dtype="float32")
    state = init_train_state(vcfg, opt, SEED, DEVICE)
    batch = device_batch(SyntheticLMData(vcfg, 2, 256, seed=SEED).batch(0))
    gk, mk = train_grads(vcfg, opt, state, batch, remat="full", attention_impl="kernel")
    gd, md = train_grads(vcfg, opt, state, batch, remat="full", attention_impl="dense")
    e_loss = abs(float(mk["loss"]) - float(md["loss"])) / abs(float(md["loss"]))
    check(math.isfinite(float(mk["loss"])) and e_loss <= 1e-3,
          f"{vcfg.name} train loss kernel vs dense: rel err {e_loss} > 1e-3")
    e_vis = check_grads(gk, gd, f"{vcfg.name} train grads kernel vs dense")
    L = vcfg.num_layers
    want = [{"flash_attention": 2 * L,
             "paged_attention": 0, "ssd_chunk": 0, "rmsnorm": 2 * 2 * L + 1},
            {"flash_attention": 0, "paged_attention": 0, "ssd_chunk": 0, "rmsnorm": 2 * 2 * L + 1}]
    del state, gk, gd
    torch.cuda.empty_cache()

    hcfg = get_config(HYBRID_ARCH).replace(num_layers=1, param_dtype="float32",
                                           compute_dtype="float32")
    state = init_train_state(hcfg, opt, SEED, DEVICE)
    batch = device_batch(SyntheticLMData(hcfg, 1, 512, seed=SEED).batch(0))
    g_cpu, m_cpu = train_grads(hcfg, opt, tree_map(lambda a: a.cpu(), state),
                               tree_map(lambda a: a.cpu(), batch), remat="none",
                               attention_impl="kernel")
    e_hyb = {}
    for remat in ("none", "dots", "full"):
        g, m = train_grads(hcfg, opt, state, batch, remat=remat, attention_impl="kernel")
        e_l = abs(float(m["loss"]) - float(m_cpu["loss"])) / abs(float(m_cpu["loss"]))
        check(e_l <= 1e-3, f"{hcfg.name} train loss card ({remat}) vs CPU: rel err {e_l}")
        e_hyb[remat] = check_grads(g, g_cpu, f"{hcfg.name} train grads card ({remat}) vs CPU")
        passes = 1 if remat == "none" else 2
        want.append({"flash_attention": passes, "paged_attention": 0, "ssd_chunk": passes,
                     "rmsnorm": 3 * passes + 1})
    log(f"[train f32] {vcfg.name} {L} layers, batch 2 x ({vcfg.num_patches} patches + "
        f"256 tokens), AdamW, remat full: loss {float(mk['loss']):.6g}, kernel vs dense "
        f"loss rel err {e_loss:.3g}, worst grad leaf err / max |g| {e_vis:.3g}; "
        f"{hcfg.name} 1 layer, S 512, card (three kernels) vs CPU (plain): worst grad "
        f"leaf err / max |g| by remat {json.dumps(e_hyb)}")
    del state
    torch.cuda.empty_cache()
    return add_launches(*want)


def phase_train_bf16():
    """internvl2-1b at full width and depth in bf16: TRAIN_STEPS steps of
    make_train_step, AdamW on a cosine schedule, remat "full", the flash
    kernel, 2 microbatches of a batch of 4 x (256 patch embeddings + 256
    tokens) from the port's SyntheticLMData. Checks loss, grad norm and
    every parameter finite and every weight changed; logs each step's
    loss and ms (CUDA events) and the peak memory. Returns the launches:
    per microbatch 2L flash and 4L+1 RMSNorm (remat reruns the layer
    bodies' forward)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import cosine_schedule
    from repro_torch.train.train_step import StepConfig, init_train_state, make_train_step
    cfg = get_config(VISION_ARCH)
    check(cfg.param_dtype == "bfloat16" and cfg.compute_dtype == "bfloat16",
          f"{cfg.name} trains in bf16")
    opt = AdamW(cosine_schedule(3e-4, warmup_steps=1, total_steps=TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, opt, SEED, DEVICE)
    first = {k: v.clone() for k, v in leaves_by_path(state["params"]).items()}
    data = SyntheticLMData(cfg, 4, 256, seed=SEED)
    step = make_train_step(cfg, opt, StepConfig(microbatches=2, remat="full",
                                                attention_impl="kernel"))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    steps = []
    for i in range(TRAIN_STEPS):
        batch = device_batch(data.batch(i))
        start.record()
        state, m = step(state, batch)
        end.record()
        end.synchronize()
        steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "ms": start.elapsed_time(end)})
        check(math.isfinite(steps[-1]["loss"]) and math.isfinite(steps[-1]["grad_norm"]),
              f"{cfg.name} bf16 train step {i}: {steps[-1]}")
    params = leaves_by_path(state["params"])
    for name, p in params.items():
        check(bool(torch.isfinite(p).all()), f"{cfg.name} bf16 train: {name} not finite")
        # every weight moves; a norm scale (1.0 at init) moves by about lr
        # per step, under half a bf16 step at 1.0 (2^-8), so it may not
        if not name.endswith("scale"):
            check(not torch.equal(p, first[name]), f"{cfg.name} bf16 train: {name} unchanged")
    changed = sum(not torch.equal(p, first[name]) for name, p in params.items())
    out = {"arch": cfg.name, "layers": cfg.num_layers, "params": sum(
        p.numel() for p in params.values()), "batch": 4, "microbatches": 2,
        "positions": cfg.num_patches + 256, "remat": "full", "optimizer": "adamw, cosine",
        "steps": steps, "leaves_changed": f"{changed} of {len(params)}",
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    log(f"[train bf16] {json.dumps(out)}")
    L = cfg.num_layers
    mb = 2 * TRAIN_STEPS
    del state, first, params
    torch.cuda.empty_cache()
    return {"flash_attention": mb * 2 * L,
            "paged_attention": 0, "ssd_chunk": 0, "rmsnorm": mb * (4 * L + 1)}


def phase_train_launcher():
    """h2o-danube-1.8b at full width and depth through the train
    launcher, as a user starts it: TRAIN_LAUNCH_STEPS steps of a batch of
    8 x 64, no checkpoint. Checks the completed steps and that both
    reported losses are finite; logs the launcher's report, ms per step
    (from its steps/s, the first step included) and the peak memory.
    Returns the launches: per step 2L flash and 4L+1 RMSNorm (remat dots
    reruns the layer bodies' forward; on the card the launcher attends
    through the flash kernel, built for danube's head dim)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as launch_train
    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = launch_train.main(["--arch", ARCH, "--steps", str(TRAIN_LAUNCH_STEPS),
                             "--batch", "8", "--seq", "64", "--device", DEVICE])
    seconds = time.perf_counter() - t0
    check(out["result"]["completed"] == TRAIN_LAUNCH_STEPS,
          f"train launcher: {out['result']}")
    check(math.isfinite(out["loss_first"]) and math.isfinite(out["loss_last"])
          and math.isfinite(out["result"]["final_loss"]), f"train launcher losses: {out}")
    log(f"[train launcher] {json.dumps({**out, 'layers': cfg.num_layers, 'params': cfg.param_count(), 'batch': 8, 'seq': 64, 'remat': 'dots', 'ms_per_step': 1e3 / out['steps_per_s'], 'seconds_with_init': seconds, 'max_memory_allocated_bytes': torch.cuda.max_memory_allocated()})}")
    torch.cuda.empty_cache()
    return {"flash_attention": TRAIN_LAUNCH_STEPS * 2 * cfg.num_layers,
            "paged_attention": 0, "ssd_chunk": 0,
            "rmsnorm": TRAIN_LAUNCH_STEPS * (4 * cfg.num_layers + 1)}


class Tee:
    """Writes to several streams: a launcher's output shown and kept."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_launcher(main, argv):
    """A launcher's ``main(argv)`` and the text it printed (also shown)."""
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(Tee(sys.stdout, buf)):
        out = main(argv)
    return out, buf.getvalue()


def rel_diffs(a, b):
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def free_cuda():
    import torch
    gc.collect()               # trainers and their buses hold cycles
    torch.cuda.empty_cache()


def phase_checkpoint():
    """A checkpoint of the sharded state, through the train launcher on
    the KND-planned 1 x 1 mesh: danube at full width and CKPT_LAYERS
    layers (``--layers``), remat dots, the flash kernel, 8 x 64 tokens,
    the launcher's cosine schedule. Run A (``--mesh 1x1 --devices 1
    --ckpt-dir``) fits CKPT_FIT steps and saves once, at step CKPT_EVERY:
    every leaf a DTensor, gathered with ``full_tensor()`` on the calling
    thread, written by rank 0 with the store co-checkpoint. Then this
    process restores that checkpoint into the unsharded state (plain
    tensors on the card). Run B (``--resume``, the same mesh, no state
    directory) adopts the checkpointed store and restores the sharded
    state. Both restores must be bit-equal to the state A saved (a copy
    gathered when it saved), B's leaves DTensors on B's mesh with the
    placements of the state they restore into; B's first loss (step
    CKPT_EVERY + 1) equals A's within 1e-6 relative; ``store.json`` loads
    into a store whose ``store_fingerprint`` is the saved file's sha256.
    Logs the codec, bytes, gather, snapshot, write and both restores'
    seconds and MB/s. Returns the launches: per step 2L flash and 4L+1
    RMSNorm (remat reruns the layer bodies), CKPT_FIT steps in each run."""
    import hashlib
    import shutil
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.api import load_store, store_fingerprint
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import cosine_schedule
    from repro_torch.train.train_step import init_train_state
    from repro_torch.tree import tree_flatten_with_paths

    cfg = get_config(ARCH).replace(num_layers=CKPT_LAYERS)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    saved, timing, sharded = {}, {}, {}
    cls = ckpt.CheckpointManager
    save, wait, restore_latest, gathered = (cls.save, cls.wait, cls.restore_latest,
                                            ckpt._gathered)

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def timed_gathered(tree):
        t0 = time.perf_counter()
        out = gathered(tree)
        torch.cuda.synchronize()
        timing["gather_s"] = time.perf_counter() - t0
        return out

    def timed_save(self, step, tree):
        # the state as saved, kept to hold both restores against
        # (a comparison: its gather is not the save's)
        saved.update((k, full(t).clone()) for k, t in tree_flatten_with_paths(tree))
        saved["_dtensors"] = sum(isinstance(t, DTensor) for _, t in tree_flatten_with_paths(tree))
        t0 = time.perf_counter()
        save(self, step, tree)
        timing["saved_at"] = time.perf_counter()
        timing["snapshot_s"] = timing["saved_at"] - t0

    def timed_wait(self):
        wait(self)
        if "saved_at" in timing and "write_s" not in timing:
            timing["write_s"] = time.perf_counter() - timing["saved_at"]

    def checked_restore(self, tree_like):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tree, step = restore_latest(self, tree_like)
        torch.cuda.synchronize()
        timing["restore_sharded_s"] = time.perf_counter() - t0
        bad = []
        for (key, like), (_, got) in zip(tree_flatten_with_paths(tree_like),
                                         tree_flatten_with_paths(tree)):
            if isinstance(like, DTensor):
                ok = (isinstance(got, DTensor) and got.device_mesh is like.device_mesh
                      and got.placements == like.placements)
            else:
                ok = not isinstance(got, DTensor)
            if not (ok and full(got).device.type == torch.device(DEVICE).type
                    and torch.equal(full(got), saved[key])):
                bad.append(key)
        sharded.update(step=step, bad=bad,
                       dtensors=sum(isinstance(t, DTensor)
                                    for _, t in tree_flatten_with_paths(tree)))
        return tree, step

    base = ["--arch", ARCH, "--layers", str(CKPT_LAYERS), "--steps", str(CKPT_FIT),
            "--batch", "8", "--seq", "64", "--device", DEVICE,
            "--mesh", "1x1", "--devices", "1", "--ckpt-dir", CKPT_DIR]
    cls.save, cls.wait, cls.restore_latest = timed_save, timed_wait, checked_restore
    ckpt._gathered = timed_gathered
    try:
        a = launch_train.main(base + ["--ckpt-every", str(CKPT_EVERY)])
        check(a["result"]["completed"] == CKPT_FIT
              and ckpt.list_checkpoints(CKPT_DIR) == [CKPT_EVERY],
              f"checkpoint: run A {a['result']}, checkpoints "
              f"{ckpt.list_checkpoints(CKPT_DIR)}")
        check(saved["_dtensors"] > 0, "run A saved no DTensor leaf")
        free_cuda()
        # the same checkpoint into the unsharded state
        like = init_train_state(cfg, AdamW(cosine_schedule(1e-3, 1, CKPT_FIT)), 1, DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain, step = ckpt.restore_checkpoint(CKPT_DIR, like)
        torch.cuda.synchronize()
        restore_plain_s = time.perf_counter() - t0
        leaves = tree_flatten_with_paths(plain)
        check(step == CKPT_EVERY and sorted(k for k, _ in leaves)
              == sorted(k for k in saved if k != "_dtensors"),
              f"unsharded restore: step {step}, leaves differ from the saved")
        for key, got in leaves:
            check(not isinstance(got, DTensor) and got.device.type == torch.device(DEVICE).type
                  and torch.equal(got, saved[key]),
                  f"unsharded restore: leaf {key} is not the saved one, bit for bit")
        del like, plain, leaves
        free_cuda()
        b, text = run_launcher(launch_train.main, base + ["--resume", "--ckpt-every", "1000"])
    finally:
        cls.save, cls.wait, cls.restore_latest = save, wait, restore_latest
        ckpt._gathered = gathered
    check(f"[resume] from step {CKPT_EVERY}" in text and "[knd] adopted checkpointed store" in text,
          "run B did not resume from the checkpoint and its store")
    check(sharded.get("step") == CKPT_EVERY and not sharded["bad"] and sharded["dtensors"] > 0,
          f"sharded restore: {sharded}")
    # the checkpoint of step CKPT_EVERY holds the state after it: B
    # trains from step CKPT_EVERY + 1, A's last step
    rel = rel_diffs(b["losses"][:1], a["losses"][CKPT_EVERY + 1:])
    check(max(rel) <= 1e-6, f"resumed losses {b['losses']} vs {a['losses']}: rel {rel}")
    step_dir = os.path.join(CKPT_DIR, f"step_{CKPT_EVERY:08d}")
    with open(os.path.join(step_dir, "store.json"), "rb") as f:
        blob = f.read()
    store = load_store(json.loads(blob))
    check(store_fingerprint(store) == hashlib.sha256(blob).hexdigest()
          and store.try_get("Workload", "train-job") is not None,
          "store.json does not load into the store it saved")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    raw = sum(t.numel() * t.element_size() for k, t in saved.items() if k != "_dtensors")
    disk = os.path.getsize(os.path.join(step_dir, ckpt.SHARD))
    report = {
        "arch": cfg.name, "layers": CKPT_LAYERS, "params": cfg.param_count(),
        "mesh": "1x1", "leaves": len(saved) - 1, "dtensor_leaves": saved["_dtensors"],
        "codec": manifest["codec"], "raw_bytes": raw, "disk_bytes": disk,
        "gather_s": timing["gather_s"], "snapshot_s": timing["snapshot_s"],
        "write_s": timing["write_s"], "write_mb_per_s": raw / timing["write_s"] / 1e6,
        "restore_sharded_s": timing["restore_sharded_s"],
        "restore_sharded_mb_per_s": raw / timing["restore_sharded_s"] / 1e6,
        "restore_plain_s": restore_plain_s,
        "restore_plain_mb_per_s": raw / restore_plain_s / 1e6,
        "store_objects": len(store), "losses_a": a["losses"], "losses_b": b["losses"],
        "loss_rel_diff": rel}
    log(f"[checkpoint] codec {manifest['codec']}; {json.dumps(report)}")
    saved.clear()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    free_cuda()
    return {"flash_attention": 2 * CKPT_FIT * 2 * CKPT_LAYERS, "paged_attention": 0, "ssd_chunk": 0,
            "rmsnorm": 2 * CKPT_FIT * (4 * CKPT_LAYERS + 1)}


@contextlib.contextmanager
def obs_capture():
    """A fresh metrics registry for one launcher run, and the tracers its
    ``--obs-dir`` installs (recorded through ``repro_torch.obs.install_tracer``,
    which the launchers import when they run)."""
    import repro_torch.obs as obs
    install, tracers = obs.install_tracer, []

    def recording(tracer):
        if tracer is not None:
            tracers.append(tracer)
        install(tracer)

    obs.install_tracer = recording
    try:
        with obs.installed(obs.MetricsRegistry()):
            yield tracers
    finally:
        obs.install_tracer = install


def metric(metrics, name, **labels):
    """A counter's or gauge's value, or a histogram's count, from a
    ``metrics.json`` (None when the instrument has no such sample)."""
    for sample in metrics.get(name, {}).get("samples", []):
        if sample["labels"] == labels:
            return sample["value"] if "value" in sample else sample["count"]
    return None


def obs_artifacts(out_dir, tracers, what):
    """The artifacts of one ``--obs-dir`` run: all three files written,
    the tracer's span trees well-formed (the port's ``validate_spans``:
    monotonic, nested, gap-free) and each of them in ``spans.json``.
    Returns ``metrics.json`` and the trees, {root name: child names}."""
    from repro_torch.obs import validate_spans
    paths = {n: os.path.join(out_dir, n) for n in ("metrics.prom", "metrics.json", "spans.json")}
    check(all(os.path.isfile(p) for p in paths.values()), f"{what}: artifacts {paths}")
    check(len(tracers) == 1, f"{what}: {len(tracers)} tracers installed")
    spans = tracers[0].spans()
    problems = validate_spans(spans)
    check(problems == [], f"{what}: malformed spans {problems[:5]}")
    with open(paths["spans.json"]) as f:
        events = [e for e in json.load(f)["traceEvents"] if e["ph"] == "X"]
    check(len(events) == sum(1 + len(r.children) for r in spans),
          f"{what}: spans.json holds {len(events)} spans")
    with open(paths["metrics.json"]) as f:
        metrics = json.load(f)
    return metrics, {r.name: [c.name for c in r.children] for r in spans}


def check_plane_trees(trees, claims, workload, what):
    """Every claim's lifecycle reaches Prepared (a claim has no Ready
    condition) and the workload's reaches Ready."""
    for c in claims:
        phases = trees.get(f"ResourceClaim/{c}#cycle0", [])
        check("Allocated" in phases and phases[-1:] == ["Prepared"],
              f"{what}: claim {c} spans {phases}")
    phases = trees.get(f"Workload/{workload}#cycle0", [])
    check(phases[-1:] == ["Ready"], f"{what}: workload {workload} spans {phases}")


def served_requests(argv):
    """The serve launcher's report, its requests in uid order and its
    engines' ticks (read through ``Router.run``)."""
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve.router import Router
    run = Router.run
    done, routers = [], {}

    def recording(self, *args, **kw):
        out = run(self, *args, **kw)
        done.extend(out)
        routers[id(self)] = self
        return out

    Router.run = recording
    try:
        out, text = run_launcher(launch_serve.main, argv)
    finally:
        Router.run = run
    ticks = sum(e.steps for r in routers.values() for e in r._replicas.values())
    return out, text, sorted(done, key=lambda r: r.uid), ticks


def phase_knd_serve():
    """[knd serve]: h2o-danube-1.8b at full size served through the serve
    launcher, KND_REQUESTS requests of 8 new tokens, 2 slots: first as
    plain (no control plane), then from a reconciled replica set
    (``--claim-chips 1 --state-dir --node-plane``, the informer threaded):
    the workload Ready, one claim per slot, the router's replica named
    after the stamped claim, ``outputs["slo"]`` holding the published
    TTFT and TPOT, the informer reconciling at least once, and every
    request's greedy tokens equal to the plain run's. The replica-set
    run also takes ``--obs-dir``: its ``metrics.json`` counts every
    request admitted and completed, the engine's ticks and one TTFT per
    request, and its tracer holds one gap-free Request tree per request
    and the claims' and workload's lifecycles. Then ``--slots 3``
    on the same state directory adopts both recovered claims with
    byte-identical allocations (``allocation_records``) and stamps
    exactly one. Returns the launches: 2L+1 RMSNorm per engine tick of
    the three runs, no flash (the engine's ticks are paged decode)."""
    import shutil
    from repro_torch.api import allocation_records, recover_store
    from repro_torch.configs.registry import get_config
    cfg = get_config(ARCH)
    for d in (KND_SERVE_DIR, KND_OBS_DIR):
        shutil.rmtree(d, ignore_errors=True)
    base = ["--arch", ARCH, "--requests", str(KND_REQUESTS), "--new-tokens", "8",
            "--device", DEVICE]
    knd = ["--claim-chips", "1", "--state-dir", KND_SERVE_DIR, "--node-plane"]
    plain, _, plain_reqs, ticks_plain = served_requests(base + ["--slots", "2"])
    free_cuda()
    with obs_capture() as tracers:
        out, text, reqs, ticks = served_requests(base + ["--slots", "2"] + knd
                                                 + ["--obs-dir", KND_OBS_DIR])
    free_cuda()
    metrics, trees = obs_artifacts(KND_OBS_DIR, tracers, "knd serve --obs-dir")
    counted = {k: metric(metrics, f"plane_torch_serve_{k}") for k in
               ("admitted_total", "completed_total", "steps_total")}
    counted["ttft"] = metric(metrics, "plane_torch_serve_ttft_seconds", arm="baseline")
    check(counted == {"admitted_total": KND_REQUESTS, "completed_total": KND_REQUESTS,
                      "steps_total": ticks, "ttft": KND_REQUESTS}
          and sorted(out["obs"]) == ["metrics.json", "metrics.prom", "spans.json"],
          f"knd serve --obs-dir: {counted}, {ticks} ticks, {out.get('obs')}")
    requests = {k: v for k, v in trees.items() if k.startswith("Request/")}
    check(len(requests) == KND_REQUESTS
          and all(v == ["queued", "prefill", "decode"] for v in requests.values()),
          f"knd serve --obs-dir: request spans {requests}")
    claims = out["knd"]["replica_claims"]
    store, _ = recover_store(KND_SERVE_DIR)
    wl = store.get("Workload", "serve")
    slo = wl.status.outputs.get("slo", {}).get("baseline", {})
    before = allocation_records(store)
    check("[knd] serve replica set Ready: 2 claims (1 chips each)" in text
          and wl.is_true("Ready", current=True) and len(claims) == 2
          and sorted(before) == claims and list(out["dispatch"]) == claims[:1],
          f"knd serve: claims {claims}, records {sorted(before)}, dispatch {out['dispatch']}")
    check(all(slo.get(k, 0) > 0 for k in ("p50_ttft_ms", "p95_ttft_ms",
                                           "p50_tpot_ms", "p95_tpot_ms")),
          f"knd serve: outputs['slo'] {wl.status.outputs.get('slo')}")
    check(out["knd"]["informer"]["reconciled"] > 0, f"knd serve: informer {out['knd']}")
    check(out["completed"] == plain["completed"] == KND_REQUESTS
          and [r.generated for r in reqs] == [r.generated for r in plain_reqs],
          "knd serve: the greedy tokens differ from the plain launcher's")
    again, text2, _, ticks_again = served_requests(base + ["--slots", "3"] + knd)
    free_cuda()
    store, _ = recover_store(KND_SERVE_DIR)
    after = allocation_records(store)
    check("[knd] recovered" in text2 and "'adopted': 2" in text2
          and len(again["knd"]["replica_claims"]) == 3
          and {k: after[k] for k in before} == before and len(set(after) - set(before)) == 1,
          f"knd serve resize: {again['knd']}, records {sorted(after)}")
    check_plane_trees(trees, claims, "serve", "knd serve --obs-dir")
    report = {"arch": ARCH, "requests": KND_REQUESTS, "new_tokens": 8,
              "obs": {"metrics": counted, "span_trees": len(trees)},
              "replica_claims": claims, "submit_to_ready_ms": out["knd"]["submit_to_ready_ms"],
              "informer": out["knd"]["informer"], "slo": wl.status.outputs["slo"],
              "resized_claims": again["knd"]["replica_claims"],
              "resized_submit_to_ready_ms": again["knd"]["submit_to_ready_ms"],
              "resized_informer": again["knd"]["informer"],
              "ticks": [ticks_plain, ticks, ticks_again], "sample": out["sample"]}
    log(f"[knd serve] {json.dumps(report)}")
    for d in (KND_SERVE_DIR, KND_OBS_DIR):
        shutil.rmtree(d, ignore_errors=True)
    served = ticks_plain + ticks + ticks_again
    return {"flash_attention": 0, "paged_attention": served * paged_per_tick(cfg),
            "ssd_chunk": 0, "rmsnorm": served * (2 * cfg.num_layers + 1)}


def phase_knd_train():
    """[knd train]: h2o-danube-1.8b at full size through the train
    launcher, KND_STEPS steps of 8 x 64, remat dots, the flash kernel:
    first without a mesh, then with ``--mesh 1x1 --devices 1 --state-dir
    --node-plane`` (the claim and workload reconciled by the informer
    threads, the ``DeviceMesh`` built on one of them by the
    AttachmentController): the ``[knd] MeshPlan[aligned]`` line, each
    step's loss and grad norm within 1e-4 relative of the run without a
    mesh. The meshed run also takes ``--obs-dir``: its three artifacts,
    its tracer's spans well-formed, the claim's lifecycle reaching
    Prepared and the workload's Ready, and a reconcile latency recorded
    for both kinds. A third run on the same state directory adopts the
    claim with its allocation unchanged. Logs ms per step (the launcher's
    steps/s).
    Returns the launches: per step 2L flash and 4L+1 RMSNorm, three runs."""
    import shutil
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train as launch_train
    cfg = get_config(ARCH)
    L = cfg.num_layers
    for d in (KND_TRAIN_DIR, KND_OBS_DIR):
        shutil.rmtree(d, ignore_errors=True)
    base = ["--arch", ARCH, "--steps", str(KND_STEPS), "--batch", "8", "--seq", "64",
            "--device", DEVICE]
    knd = ["--mesh", "1x1", "--devices", "1", "--state-dir", KND_TRAIN_DIR, "--node-plane"]
    plain = launch_train.main(base)
    free_cuda()
    with obs_capture() as tracers:
        meshed, text = run_launcher(launch_train.main,
                                    base + knd + ["--obs-dir", KND_OBS_DIR])
    free_cuda()
    metrics, trees = obs_artifacts(KND_OBS_DIR, tracers, "knd train --obs-dir")
    check(f"[obs] artifacts: {os.path.join(KND_OBS_DIR, 'metrics.json')}" in text,
          "knd train --obs-dir: no [obs] line")
    check_plane_trees(trees, ["train"], "train-job", "knd train --obs-dir")
    reconciles = {k: metric(metrics, "plane_torch_runtime_reconcile_seconds", kind=k)
                  for k in ("ResourceClaim", "Workload")}
    check(all(n and n > 0 for n in reconciles.values()),
          f"knd train --obs-dir: reconcile latencies {reconciles}")
    rels = {k: rel_diffs(meshed[k], plain[k]) for k in ("losses", "grad_norms")}
    check("[knd] MeshPlan[aligned] data=1" in text and meshed["knd"]["mesh"]
          == {"data": 1, "model": 1}, f"knd train: {meshed.get('knd')}")
    for key, rel in rels.items():
        check(len(rel) == KND_STEPS and max(rel) <= 1e-4,
              f"knd train {key}: mesh {meshed[key]} vs {plain[key]}, rel {rel} > 1e-4")
    again, text2 = run_launcher(launch_train.main, base + knd)
    free_cuda()
    check("[knd] recovered" in text2 and (again["knd"]["adopted"] or {}).get("adopted") == 1
          and again["knd"]["allocation_records"] == meshed["knd"]["allocation_records"],
          f"knd train rerun: {again['knd']}")
    report = {"arch": ARCH, "params": cfg.param_count(), "steps": KND_STEPS, "batch": 8,
              "seq": 64, "plan": meshed["knd"]["plan"],
              "submit_to_ready_ms": [meshed["knd"]["submit_to_ready_ms"],
                                     again["knd"]["submit_to_ready_ms"]],
              "informer": [meshed["knd"]["informer"], again["knd"]["informer"]],
              "adopted": again["knd"]["adopted"],
              "obs": {"reconciles_timed": reconciles, "span_trees": len(trees)},
              "losses": meshed["losses"], "grad_norms": meshed["grad_norms"],
              "rel_diff": rels, "bit_equal": rels == {k: [0.0] * KND_STEPS for k in rels},
              "ms_per_step_incl_first": {r: 1e3 / o["steps_per_s"] for r, o in
                                         (("plain", plain), ("mesh", meshed), ("rerun", again))}}
    log(f"[knd train] {json.dumps(report)}")
    for d in (KND_TRAIN_DIR, KND_OBS_DIR):
        shutil.rmtree(d, ignore_errors=True)
    return {"flash_attention": 3 * KND_STEPS * 2 * L, "paged_attention": 0, "ssd_chunk": 0,
            "rmsnorm": 3 * KND_STEPS * (4 * L + 1)}


@contextlib.contextmanager
def nccl_group():
    """A process group of world size 1 over NCCL, rendezvous on a free
    localhost port, destroyed on exit."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def phase_mesh_plan():
    """The KND workflow of the JAX package's SPMD test on the smallest pod
    the planner accepts (1 x 1): TpuDriver and IciDriver discovery, a
    one-chip claim through the StructuredAllocator, an aligned data x
    model plan, then ``MeshRuntime.execute``: it must refuse without a
    process group, and build a 1 x 1 ``DeviceMesh`` on cuda over an NCCL
    group of world size 1, which is destroyed at the end of the phase.
    Returns the plan."""
    from repro_torch.core import (AxisSpec, DriverRegistry, IciDriver, MeshPlanner,
                                  MeshRuntime, StructuredAllocator, TpuDriver)
    from repro_torch.topology.tpu import TpuPodSpec, build_tpu_cluster
    cluster = build_tpu_cluster(1, TpuPodSpec(x=1, y=1))
    reg = DriverRegistry()
    reg.add(TpuDriver(cluster)).add(IciDriver(cluster))
    published = reg.run_discovery()
    planner = MeshPlanner(cluster)
    claim = planner.make_claim("chip-smoke", 1)
    result = StructuredAllocator(reg.pool, reg.classes).allocate(claim)
    plan = planner.plan([AxisSpec("data", 1, "y"), AxisSpec("model", 1, "x")],
                        "aligned", claim)
    runtime = MeshRuntime()
    try:
        runtime.execute(plan.attachment())
        refused = False
    except RuntimeError:
        refused = True
    check(refused, "MeshRuntime.execute built a mesh without a process group")
    with nccl_group():
        mesh = runtime.execute(plan.attachment())
        check(mesh.device_type == "cuda" and mesh.mesh_dim_names == ("data", "model")
              and mesh.mesh.tolist() == [[0]], f"planned mesh {mesh}")
        log(f"[mesh plan] {plan.summary()}; published {published} devices; claim "
            f"{[a.ref.id for a in result.devices]}; {mesh}")
    return plan


def phase_mesh_train(mesh):
    """h2o-danube-1.8b at full size through the Trainer, MESH_STEPS AdamW
    steps of 8 x 64 tokens, remat dots, the flash kernel: first under
    ``use_rules(ShardingRules(mesh=mesh))`` on the planned 1 x 1 mesh
    over NCCL, then, its state freed, with no rules. Before the runs, RMSNorm
    and flash on DTensors at the run's shapes against their plain
    versions. Holds each step's loss and grad norm within 1e-4 relative
    between the runs, every parameter a DTensor on cuda after the mesh
    run, and each run's launches (counters set to 0 just before it, read
    just after) to the count the code gives: per step 2L flash and 4L+1
    RMSNorm (remat dots reruns the layer bodies' forward). Logs ms per
    step by CUDA events between STEP_BEGIN and STEP_END and each run's
    peak memory. Returns both runs' launches and the mesh run's last
    gradient tree (the pod mean's input)."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.configs.registry import get_config
    from repro_torch.core import Events, KNDDriver
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.parallel.sharding import ShardingRules, use_rules
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import constant_schedule
    from repro_torch.train.train_step import StepConfig
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves

    class StepRecorder(KNDDriver):
        """CUDA events at STEP_BEGIN and STEP_END, and each step's metrics."""
        name = "steps.chip-smoke"

        def __init__(self):
            super().__init__()
            self.events, self.metrics = [], []

        def register(self, bus):
            bus.subscribe(Events.STEP_BEGIN, self.on_begin, self.name)
            bus.subscribe(Events.STEP_END, self.on_end, self.name)

        def on_begin(self, event):
            self.events.append([torch.cuda.Event(enable_timing=True)])
            self.events[-1][0].record()

        def on_end(self, event):
            self.events[-1].append(torch.cuda.Event(enable_timing=True))
            self.events[-1][1].record()
            self.metrics.append({k: float(v) for k, v in event.context["metrics"].items()})

    cfg = get_config(ARCH)
    L = cfg.num_layers
    want = {"flash_attention": MESH_STEPS * 2 * L, "paged_attention": 0, "ssd_chunk": 0,
            "rmsnorm": MESH_STEPS * (4 * L + 1)}

    def run(rules, capture):
        rec = StepRecorder()
        gc.collect()          # earlier phases' trainers hold cycles too
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with use_rules(rules):
            tr = Trainer(cfg, AdamW(constant_schedule(1e-4)),
                         SyntheticLMData(cfg, 8, 64, seed=SEED),
                         step_cfg=StepConfig(remat="dots", attention_impl="kernel"),
                         drivers=[rec], grad_transform=capture, device=DEVICE)
            tr.init(SEED)
            reset_launch_counts()
            out = tr.fit(MESH_STEPS)
            counts = launch_counts()
        torch.cuda.synchronize()
        check(out["completed"] == MESH_STEPS, f"mesh train: fit {out}")
        ms = [b.elapsed_time(e) for b, e in rec.events]
        return tr, rec.metrics, ms, counts, torch.cuda.max_memory_allocated()

    kept = {}

    def keep_grads(grads):
        kept["grads"] = grads
        return grads

    rules = ShardingRules(mesh=mesh)
    rep = [Replicate(), Replicate()]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    x = torch.randn((8, 64, cfg.d_model), generator=gen, device=DEVICE,
                    dtype=torch.bfloat16)
    s = 1 + 0.1 * torch.randn((cfg.d_model,), generator=gen, device=DEVICE,
                              dtype=torch.bfloat16)
    xd = distribute_tensor(x, mesh, [Shard(0), Shard(1)])
    got = rmsnorm(xd, distribute_tensor(s, mesh, rep), cfg.norm_eps)
    err_rms = max_abs(got.to_local(), rmsnorm_ref(x, s, cfg.norm_eps))
    check(isinstance(got, DTensor) and err_rms <= BF16_TOL,
          f"rmsnorm on a DTensor: max abs err {err_rms} > {BF16_TOL}")
    hd, H, K = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    q, k, v = (torch.randn((8, 64, n, hd), generator=gen, device=DEVICE,
                           dtype=torch.bfloat16) for n in (H, K, K))
    got = flash_attention(*(distribute_tensor(t, mesh, [Shard(0), Shard(1)])
                            for t in (q, k, v)), causal=True, window=cfg.sliding_window)
    err_fl = row_rel_err(got.to_local(), attention_ref(q, k, v, causal=True,
                                                       window=cfg.sliding_window))
    check(isinstance(got, DTensor) and err_fl <= FLASH_ROW_REL_TOL["torch.bfloat16"],
          f"flash on a DTensor: row rel err {err_fl}")
    del x, xd, s, q, k, v, got
    tr, m_mesh, ms_mesh, c_mesh, peak_mesh = run(rules, keep_grads)
    leaves = tree_leaves(tr.state["params"])
    check(all(isinstance(p, DTensor) and p.device.type == "cuda"
              and p.device_mesh is mesh for p in leaves),
          "after the mesh run a parameter is not a DTensor on the cuda mesh")
    del tr, leaves
    gc.collect()              # the trainer and its bus's handlers hold a cycle
    torch.cuda.empty_cache()
    tr, m_plain, ms_plain, c_plain, peak_plain = run(None, None)
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    rels = {key: [abs(a[key] - b[key]) / abs(b[key]) for a, b in zip(m_mesh, m_plain)]
            for key in ("loss", "grad_norm")}
    report = {"arch": ARCH, "params": cfg.param_count(), "steps": MESH_STEPS,
              "batch": 8, "seq": 64, "remat": "dots", "attention": "kernel",
              "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
              "rmsnorm_dtensor_max_abs_err": err_rms,
              "flash_dtensor_row_rel_err": err_fl,
              "loss_mesh": [m["loss"] for m in m_mesh],
              "loss_plain": [m["loss"] for m in m_plain],
              "grad_norm_mesh": [m["grad_norm"] for m in m_mesh],
              "grad_norm_plain": [m["grad_norm"] for m in m_plain],
              "ms_per_step_mesh": ms_mesh, "ms_per_step_plain": ms_plain,
              "max_memory_allocated_bytes_mesh": peak_mesh,
              "max_memory_allocated_bytes_plain": peak_plain,
              "rel_diff": rels, "launches_mesh": c_mesh, "launches_plain": c_plain}
    log(f"[mesh train] {json.dumps(report)}")
    for key, rel in rels.items():
        check(max(rel) <= 1e-4, f"mesh train {key}: mesh {[m[key] for m in m_mesh]} vs "
              f"{[m[key] for m in m_plain]}, rel {rel} > 1e-4")
    check(c_mesh == want and c_plain == want,
          f"mesh train launches: mesh {c_mesh}, plain {c_plain}, want {want}")
    return {"mesh_run": c_mesh, "plain_run": c_plain}, kept["grads"]


def phase_pod_mean(grads):
    """``compressed_pod_mean`` over the mesh run's gradient tree with one
    pod over the NCCL group: the tensor of the SUM all_reduce must be
    int8, every mean bit-equal to the plain single-process arithmetic on
    the same leaf (g + err, amax, scale = max(amax, 1e-20) * npods / 127,
    round and clip to +-(127 // npods), int8, back times scale / npods),
    and the new error within one quantisation step of zero."""
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.collectives import compressed_pod_mean, zeros_like_tree
    from repro_torch.tree import tree_flatten_with_paths

    npods = 1
    err = zeros_like_tree(grads, torch.float32)
    wire = []
    all_reduce = dist.all_reduce

    def recording(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        wire.append((str(op), tensor.dtype, tensor.numel()))
        return all_reduce(tensor, op=op, group=group, async_op=async_op)

    dist.all_reduce = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, new_err = compressed_pod_mean(grads, err, None, npods)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        dist.all_reduce = all_reduce
    sums = [w for w in wire if "SUM" in w[0]]
    leaves = tree_flatten_with_paths(grads)
    check(len(sums) == len(leaves) and all(w[1] == torch.int8 for w in sums),
          f"pod mean: the SUM all_reduces carried {sorted({str(w[1]) for w in sums})}, "
          f"want torch.int8 for each of {len(leaves)} leaves")
    worst = 0.0
    for (key, g), (_, m), (_, e) in zip(leaves, tree_flatten_with_paths(mean),
                                        tree_flatten_with_paths(new_err)):
        g = g.to_local() if hasattr(g, "to_local") else g
        m = m.to_local() if hasattr(m, "to_local") else m
        e = e.to_local() if hasattr(e, "to_local") else e
        g32 = g.float()
        scale = torch.clamp(g32.abs().max(), min=1e-20) * npods / 127.0
        q = torch.clamp(torch.round(g32 / scale), -(127 // npods), 127 // npods)
        plain = (q.to(torch.int8).float() * scale / npods).to(g.dtype)
        check(m.dtype == g.dtype and torch.equal(m, plain),
              f"pod mean of {key} differs from the plain arithmetic")
        step_err = float(e.abs().max() / scale)
        check(step_err <= 1.0, f"pod mean of {key}: new_err {step_err} quantisation steps")
        worst = max(worst, step_err)
    report = {"leaves": len(leaves), "elements": sum(g.numel() for _, g in leaves),
              "npods": npods, "sum_dtypes": sorted({str(w[1]) for w in sums}),
              "max_dtypes": sorted({str(w[1]) for w in wire if "MAX" in w[0]}),
              "seconds": seconds, "max_new_err_in_steps": worst}
    log(f"[pod mean] {json.dumps(report)}")


def ssd_dtensor_check(mesh, gen, shape, model_like):
    """The SSD chunk on DTensors (x, dt and da sharded over the batch on
    data and the heads on model, C and B over the batch) against its
    plain version on the same tensors, forward and gradient (the plain
    version's autograd, on both sides: the kernel has no backward).
    Returns the worst error relative to each output's (gradient's)
    largest magnitude, held to SSD_REL_TOL: at Q = 256 the JAX tests'
    distribution gives outputs up to ~3e2, where phase 4b's abs 1e-4 is
    ~2^-21 of them (phase 4b holds its Q = 256 cases to the same bound).
    The launches it makes are comparisons, outside any path's count."""
    import torch
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    ins = [t.requires_grad_(True) for t in ssd_inputs(gen, *shape, torch.bfloat16, model_like)]
    gs = [torch.randn(s, device=DEVICE, generator=gen) for s in (
        ins[2].shape, shape[:2] + (shape[4], shape[3], shape[5]), shape[:2] + (shape[4],))]
    pl_x, pl_cb = [Shard(0), Shard(3)], [Shard(0), Replicate()]
    dins = [distribute_tensor(t.detach(), mesh, pl).requires_grad_(True)
            for t, pl in zip(ins, [pl_cb, pl_cb, pl_x, pl_x, pl_x])]
    before = launch_counts()["ssd_chunk"]
    out = ssd_chunk(*dins)
    torch.cuda.synchronize()
    check(launch_counts()["ssd_chunk"] == before + 1
          and all(isinstance(o, DTensor) for o in out),
          f"ssd on a DTensor {shape}: not one launch with DTensor outputs")
    torch.autograd.backward([o.to_local() for o in out], gs)
    ref = ssd_chunk_ref(*ins)
    grads = torch.autograd.grad(ref, ins, gs)
    pairs = ([(o.to_local().detach(), r.detach()) for o, r in zip(out, ref)]
             + [(d.grad.to_local(), g) for d, g in zip(dins, grads)])
    err = max(max_abs(a, b) / max(float(b.abs().max()), 1e-30) for a, b in pairs)
    check(err <= SSD_REL_TOL, f"ssd on a DTensor {shape} {'model-like' if model_like else 'test'}"
                              f" distribution: rel err {err} > {SSD_REL_TOL}")
    return err


def phase_mesh_families(mesh):
    """Every family but dense trained on the planned 1 x 1 mesh over
    NCCL: first the SSD chunk on DTensors at mamba2's and hymba's prefill
    shapes (b 1, nc 8, Q 256, x bf16; N 128, H 48 and N 16, H 50) against
    its plain version, forward and gradient, at the JAX tests'
    distribution and at model-like decays; then each of
    MESH_FAMILIES at full width (grok at 1 layer, under Adafactor: AdamW's
    state would not fit beside it), MESH_FAMILY_STEPS steps of 8 x 64
    tokens, remat dots, the flash kernel, under
    ``use_rules(ShardingRules(mesh=mesh))`` and then, the first state
    freed, without rules. Holds every parameter a DTensor on cuda after
    the first run, each step's loss and grad norm within 1e-4 relative
    between the two, each run's launches (counts set to 0 just before it
    and read just after) to the code's count, and grok's dropped choices
    equal. Logs ms per step (CUDA events) and peak memory of both runs
    beside the card. Returns each run's launches."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.parallel.sharding import ShardingRules, use_rules
    from repro_torch.train.optimizer import Adafactor, AdamW
    from repro_torch.train.schedule import constant_schedule
    from repro_torch.train.train_step import StepConfig, init_train_state, make_train_step
    from repro_torch.tree import tree_leaves

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    ssd = {f"{name} {dist}": ssd_dtensor_check(mesh, gen, shape, dist == "model-like")
           for name, shape in (("mamba2", (1, 8, 256, 128, 48, 64)),
                               ("hymba", (1, 8, 256, 16, 50, 64)))
           for dist in ("test", "model-like")}
    log(f"[mesh families] ssd chunk on DTensors vs plain, forward and gradient: {ssd}")
    free_cuda()

    def launches_per_step(cfg):
        """remat dots reruns each layer body's forward: two passes per
        layer of its norms (norm1, the gated norm of an SSD, norm2),
        flash and SSD calls; one final norm."""
        L = cfg.num_layers
        norms = 1 + (cfg.family in ("ssm", "hybrid")) + (cfg.family != "ssm")
        return {"flash_attention": 2 * L * (cfg.family != "ssm"),
                "paged_attention": 0, "ssd_chunk": 2 * L * (cfg.family in ("ssm", "hybrid")),
                "rmsnorm": 2 * norms * L + 1}

    def run(cfg, opt, rules):
        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        data = SyntheticLMData(cfg, 8, 64, seed=SEED)
        metrics, ms = [], []
        with use_rules(rules), DropCounter() as drops:
            state = init_train_state(cfg, opt, SEED, DEVICE)
            step = make_train_step(cfg, opt, StepConfig(remat="dots", attention_impl="kernel"))
            reset_launch_counts()
            for s in range(MESH_FAMILY_STEPS):
                batch = device_batch(data.batch(s))
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, m = step(state, batch)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
                metrics.append({k: float(v) for k, v in m.items()})
            counts = launch_counts()
        dtensors = all(isinstance(p, DTensor) and p.device.type == DEVICE
                       and p.device_mesh is mesh for p in tree_leaves(state["params"]))
        peak = torch.cuda.max_memory_allocated()
        del state, step
        free_cuda()
        return {"metrics": metrics, "ms": ms, "counts": counts, "peak": peak,
                "drops": drops.drops, "dtensors": dtensors}

    card = gpu_line()
    runs = {}
    for arch, layers, opt_name in MESH_FAMILIES:
        cfg = get_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        opt = (AdamW if opt_name == "adamw" else Adafactor)(constant_schedule(1e-4))
        meshed = run(cfg, opt, ShardingRules(mesh=mesh))
        plain = run(cfg, opt, None)
        per_step = launches_per_step(cfg)
        want = {k: MESH_FAMILY_STEPS * v for k, v in per_step.items()}
        rels = {key: rel_diffs([m[key] for m in meshed["metrics"]],
                               [m[key] for m in plain["metrics"]])
                for key in ("loss", "grad_norm")}
        report = {"arch": arch, "layers": cfg.num_layers, "params": cfg.param_count(),
                  "optimizer": opt_name, "steps": MESH_FAMILY_STEPS, "batch": 8, "seq": 64,
                  "remat": "dots", "attention": "kernel", "card": card,
                  "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                  "loss_mesh": [m["loss"] for m in meshed["metrics"]],
                  "loss_plain": [m["loss"] for m in plain["metrics"]],
                  "grad_norm_mesh": [m["grad_norm"] for m in meshed["metrics"]],
                  "grad_norm_plain": [m["grad_norm"] for m in plain["metrics"]],
                  "rel_diff": rels, "ms_per_step_mesh": meshed["ms"],
                  "ms_per_step_plain": plain["ms"],
                  "max_memory_allocated_bytes_mesh": meshed["peak"],
                  "max_memory_allocated_bytes_plain": plain["peak"],
                  "drops_mesh": meshed["drops"], "drops_plain": plain["drops"],
                  "launches_mesh": meshed["counts"], "launches_plain": plain["counts"]}
        log(f"[mesh families] {json.dumps(report)}")
        check(meshed["dtensors"], f"mesh families {arch}: after the mesh run a parameter "
                                  f"is not a DTensor on the cuda mesh")
        for key, rel in rels.items():
            check(all(math.isfinite(m[key]) for m in meshed["metrics"] + plain["metrics"])
                  and max(rel) <= 1e-4, f"mesh families {arch} {key}: rel {rel} > 1e-4")
        check(meshed["counts"] == want and plain["counts"] == want,
              f"mesh families {arch} launches: mesh {meshed['counts']}, "
              f"plain {plain['counts']}, want {want}")
        check(meshed["drops"] == plain["drops"],
              f"mesh families {arch}: dropped {meshed['drops']} choices on the mesh, "
              f"{plain['drops']} without")
        runs[f"{arch} mesh"], runs[f"{arch} plain"] = meshed["counts"], plain["counts"]
    return runs


def prompt_batch(cfg, rng, S):
    """lm.prefill's inputs for a random S-token prompt on the card: ids
    (1, S), codes (1, S, ncb) for the audio family, and for the vision
    family ``num_patches`` random patch embeddings in front of the text."""
    import torch
    shape = (1, S, cfg.num_codebooks) if cfg.frontend == "audio" else (1, S)
    batch = {"tokens": torch.tensor(rng.randint(0, cfg.vocab_size, size=shape),
                                    device=DEVICE)}
    if cfg.frontend == "vision":
        pe = rng.standard_normal((1, cfg.num_patches, cfg.vit_dim)).astype("float32")
        batch["patch_embeds"] = torch.tensor(pe, device=DEVICE)
    return batch


def phase_serve_bf16(rng, arch, layers=None, requests=8):
    """Serving in bf16 through the Router: ``requests`` requests, prompts
    uniform in 64-512 tokens, 32 new tokens, 4 slots, chunk 16, max_len
    1024; before it, a bf16 2048-token lm.prefill (for the moe family
    with its drop count; for vision behind 256 patch embeddings, for
    audio on 4 codebooks) and, for the ssm family, two more on the same
    prompt (:func:`prefill_timing`). ``layers`` cuts the depth. Returns
    the config, the parameters, the prefill timing (None for other
    families) and the serving stats."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.router import Router
    from repro_torch.serve.slo import SloTracker
    cfg = get_config(arch)
    full_depth = cfg.num_layers
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    check(cfg.param_dtype == "bfloat16" and cfg.compute_dtype == "bfloat16",
          f"{arch} serves in bf16")
    params = lm.init_params(cfg, SEED, DEVICE)
    batch = prompt_batch(cfg, rng, 2048)
    toks = batch["tokens"]
    before = launch_counts()
    with torch.no_grad(), DropCounter() as drops:
        lk, _ = lm.prefill(cfg, params, batch, attention_impl="kernel")
    check(bool(torch.isfinite(lk.float()).all()), "bf16 prefill logits not finite")
    if cfg.num_experts > 0:
        log(f"[prefill bf16] {cfg.name} {cfg.num_layers} of {full_depth} layers, 2048 "
            f"tokens: {drops.drops} of {2048 * cfg.top_k * cfg.num_layers} choices "
            f"dropped (cap {drops.cap} per expert)")
    prefill = None
    if cfg.family == "ssm":
        n_ssd = launch_counts()["ssd_chunk"] - before["ssd_chunk"]
        check(n_ssd == cfg.num_layers, f"bf16 prefill made {n_ssd} SSD launches, "
                                       f"not {cfg.num_layers}")
        prefill = prefill_timing(cfg, params, toks)
        log(f"[prefill bf16] {cfg.name}: {json.dumps(prefill)}")

    slo = SloTracker()
    router = Router(slo, max_queue_per_replica=8)
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=1024, prefill_chunk=16,
                      device=DEVICE, seed=SEED)
    router.add_replica("replica-0", eng)
    finite = torch.ones((), dtype=torch.bool, device=DEVICE)
    seen, widths = [], []
    capture_logits(eng, seen, widths)
    lens = rng.randint(64, 513, size=requests)
    norms_before = launch_counts()["rmsnorm"]
    paged_before = launch_counts()["paged_attention"]
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
    paged = launch_counts()["paged_attention"] - paged_before
    check(len(done) == requests and all(r.done for r in done),
          "not every request completed")
    check(bool(finite), "non-finite logits while serving")
    want = sum(norms_per_tick(cfg, C) for C in widths)
    check(len(widths) == eng.steps and norms == want,
          f"rmsnorm launches {norms} != {want} over {eng.steps} ticks")
    check(paged == eng.steps * paged_per_tick(cfg),
          f"paged-attention launches {paged} != {paged_per_tick(cfg)} per tick over "
          f"{eng.steps} ticks")
    gen = sum(len(r.generated) for r in done)
    snap = slo.arm_snapshot("baseline")
    stats = {"arch": arch, "layers": cfg.num_layers, "full_depth_layers": full_depth,
             "requests": requests, "prompt_lens": [int(n) for n in lens],
             "new_tokens": 32, "slots": 4, "prefill_chunk": 16,
             "generated_tokens": gen, "ticks": eng.steps, "wall_s": wall,
             "tokens_per_s": gen / wall, "ms_per_tick": 1e3 * wall / eng.steps,
             "p50_ttft_ms": snap["p50_ttft_ms"], "p95_ttft_ms": snap["p95_ttft_ms"],
             "p50_tpot_ms": snap["p50_tpot_ms"], "p95_tpot_ms": snap["p95_tpot_ms"],
             "rmsnorm_launches_serving": norms, "paged_launches_serving": paged}
    log(f"[serve bf16] {json.dumps(stats)}")
    return cfg, params, prefill, stats


def profile_ticks(step, n=PROFILE_TICKS):
    """``n`` serving ticks on the host clock, then ``n`` more under
    torch.profiler -> (wall ms per tick, device ms per tick or None when
    the profiler saw no device activity, the device idle share or None,
    the profile's device events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0) / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    evs = kernel_events(prof)
    busy = sum(us for *_, us in evs) / n / 1e3 if evs else None
    return wall, busy, None if busy is None else 1 - busy / wall, evs


def phase_profile(cfg, params, rng):
    """Where a serving tick's time goes, with 4 slots all prefilling
    16-token chunks and then all decoding one token: wall time per tick
    (unprofiled), device time per tick, the device's idle share and the
    top device activities (torch.profiler), for ``cfg``'s engine."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, batch_slots=4, max_len=1024, prefill_chunk=16,
                      device=DEVICE, seed=SEED)
    for _ in range(4):
        eng.submit(rng.randint(0, cfg.vocab_size, size=512).tolist(),
                   max_new_tokens=200)
    out = {}
    n = PROFILE_TICKS
    with torch.no_grad():
        for regime in ("prefill_chunk16", "decode"):
            if regime == "decode":
                while any(r is not None and r.t_first_token is None
                          for r in eng.active):
                    eng.step()
            wall, busy, idle, evs = profile_ticks(eng.step, n)
            top = sorted(evs, key=lambda e: -e[2])[:8]
            out[regime] = {
                "wall_ms_per_tick": wall, "device_ms_per_tick": busy,
                "device_idle_share": idle,
                "device_ops_per_tick": sum(c for _, c, _ in evs) / n,
                # norms_per_tick when the profiler kept every record
                "rmsnorm_launches_per_tick": norms_per_tick(
                    cfg, 16 if regime == "prefill_chunk16" else 1),
                "rmsnorm_records_per_tick": sum(
                    c for k, c, _ in evs if "rmsnorm_kernel" in k) / n,
                "top_device_ms_per_tick": [[k[:70], c / n, us / n / 1e3]
                                           for k, c, us in top]}
    check(all(r is not None and r.t_first_token is not None for r in eng.active),
          "profile engine lost a request")
    for regime, o in out.items():
        check(o["rmsnorm_records_per_tick"] > 0,
              f"{cfg.name} {regime}: the profiler recorded no rmsnorm_kernel")
    log(f"[profile {cfg.name}] {json.dumps(out)}")


@contextlib.contextmanager
def plane_arm(arm):
    """One arm of [plane cost] -> (the replica's name, the tracer or
    None). A: a disabled registry and no tracer; B: the live default
    registry and an installed tracer (what ``--obs-dir`` pays); C: B and a
    1-chip-per-slot replica set provisioned under the threaded informer,
    the tracer on the plane's store, the informer running while the engine
    serves; D: C reconciled inline (the control without plane threads)."""
    from repro_torch.launch.serve import provision_replicas
    from repro_torch.obs import MetricsRegistry, Tracer, installed, installed_tracer
    if arm == "A":
        with installed(MetricsRegistry(enabled=False)):
            yield "replica-0", None
        return
    with installed_tracer(Tracer()) as tracer:
        if arm == "B":
            yield "replica-0", tracer
            return
        plane, wl = provision_replicas(4, 1, tracer=tracer, reconcile_mode=(
            "threaded" if arm == "C" else "inline"))
        try:
            check((plane.informer is not None) == (arm == "C")
                  and len(wl.status.outputs["claims"]) == 4,
                  f"plane cost {arm}: {wl.status.outputs.get('claims')}")
            yield wl.status.outputs["claims"][0], tracer
        finally:
            if plane.informer is not None:
                plane.informer.stop()
            tracer.detach()


def serve_arm(cfg, params, prompts, arm, profile):
    """The serving phases' load through a Router and a ServeEngine under
    ``arm`` (:func:`plane_arm`): tokens/s, ms per tick and SloTracker's
    TTFT and TPOT; with ``profile``, then 4 more requests of 64 tokens, all
    prefilled, and the device idle share of PROFILE_TICKS decode ticks
    (:func:`profile_ticks`). Returns the stats, every request's greedy
    tokens in uid order, and the engine ticks run."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.router import Router
    from repro_torch.serve.slo import SloTracker
    with plane_arm(arm) as (replica, tracer), torch.no_grad():
        slo = SloTracker()
        router = Router(slo, max_queue_per_replica=8)
        eng = ServeEngine(cfg, params, batch_slots=4, max_len=1024, prefill_chunk=16,
                          device=DEVICE, seed=SEED)
        router.add_replica(replica, eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in prompts:
            router.submit(p, max_new_tokens=32)
        done = router.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(len(done) == len(prompts) and all(r.done for r in done),
              f"plane cost {arm}: not every request completed")
        snap = slo.arm_snapshot("baseline")
        gen = sum(len(r.generated) for r in done)
        stats = {"tokens_per_s": gen / wall, "ms_per_tick": 1e3 * wall / eng.steps,
                 "ticks": eng.steps, "wall_s": wall,
                 **{k: snap[k] for k in ("p50_ttft_ms", "p95_ttft_ms",
                                         "p50_tpot_ms", "p95_tpot_ms")}}
        if tracer is not None:
            stats["trace_events"] = len(tracer.events())
        tokens = [r.generated for r in sorted(done, key=lambda r: r.uid)]
        if profile:
            for p in prompts[:4]:
                router.submit(p[:64], max_new_tokens=64)
            while any(r is None or r.t_first_token is None for r in eng.active):
                router.step()
            wall_tick, busy, idle, _ = profile_ticks(router.step)
            check(busy is not None, f"plane cost {arm}: the profiler saw no device time")
            stats["profile"] = {"wall_ms_per_tick": wall_tick, "device_ms_per_tick": busy,
                                "device_idle_share": idle}
        ticks = eng.steps
    del eng, router
    return stats, tokens, ticks


def phase_plane_cost(cfg, params):
    """[plane cost]: what the observability plane and the control plane
    cost host-bound serving. danube at full size in bf16 (``params``,
    built once) serves the serving phases' load (8 requests, prompts of
    64-512 tokens, 32 new, 4 slots, chunk 16) through the library under
    each arm of :func:`plane_arm`, in PLANE_COST_ROUNDS rounds that rotate
    the arms' order (A B C D, B C D A, ...); the first round also profiles
    each arm. Checks every run's greedy tokens equal to the first's; logs
    per arm the median, min and max of each metric, the ratio of the
    medians to A's, and the per-round ratios to A. The prompts come from a
    generator of its own, seeded with SEED, so the later phases draw what
    they drew before the phase existed. Returns the launches: 2L+1
    RMSNorm per engine tick."""
    import numpy as np
    rng = np.random.RandomState(SEED)
    lens = rng.randint(64, 513, size=8)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    runs = {a: [] for a in PLANE_COST_ARMS}
    want, ticks = None, 0
    for rnd in range(PLANE_COST_ROUNDS):
        order = PLANE_COST_ARMS[rnd % 4:] + PLANE_COST_ARMS[:rnd % 4]
        for arm in order:
            stats, tokens, n = serve_arm(cfg, params, prompts, arm, profile=rnd == 0)
            ticks += n
            want = tokens if want is None else want
            check(tokens == want, f"plane cost {arm}, round {rnd}: greedy tokens differ")
            runs[arm].append(stats)
        free_cuda()
    keys = ("tokens_per_s", "ms_per_tick", "p50_ttft_ms", "p95_ttft_ms",
            "p50_tpot_ms", "p95_tpot_ms")
    med = {a: {k: statistics.median(r[k] for r in runs[a]) for k in keys} for a in runs}
    report = {"arch": cfg.name, "layers": cfg.num_layers, "requests": len(prompts),
              "prompt_lens": [int(n) for n in lens], "new_tokens": 32, "slots": 4,
              "prefill_chunk": 16, "rounds": PLANE_COST_ROUNDS, "arms": {}}
    for a in runs:
        report["arms"][a] = {
            "median": med[a],
            "min": {k: min(r[k] for r in runs[a]) for k in keys},
            "max": {k: max(r[k] for r in runs[a]) for k in keys},
            "ratio_of_medians_to_A": {k: med[a][k] / med["A"][k] for k in keys},
            "per_round_ratio_to_A": {k: [r[k] / ra[k] for r, ra in zip(runs[a], runs["A"])]
                                     for k in ("tokens_per_s", "ms_per_tick")},
            "profile": runs[a][0]["profile"],
            "trace_events": [r.get("trace_events") for r in runs[a]],
            "runs": runs[a]}
    log(f"[plane cost] {json.dumps(report)}")
    return {"flash_attention": 0, "paged_attention": ticks * paged_per_tick(cfg),
            "ssd_chunk": 0, "rmsnorm": ticks * (2 * cfg.num_layers + 1)}


def rmsnorm_inputs(gen, shape):
    """bf16 x and scale for the kernel's timings, as a served model's."""
    import torch
    x = torch.randn(*shape, device=DEVICE, generator=gen).to(torch.bfloat16)
    s = (1 + 0.1 * torch.randn(shape[-1], device=DEVICE, generator=gen)).to(torch.bfloat16)
    return x, s


def rmsnorm_vs_library(x, s, eps) -> dict:
    """The RMSNorm kernel against ``F.rms_norm`` on the same inputs, in
    alternating windows (``time_pair``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    D = x.shape[-1]
    return time_pair(lambda: rmsnorm(x, s, eps), lambda: F.rms_norm(x, (D,), s, eps))


def phase_rmsnorm_fresh(gen):
    """The kernels line's reading at mamba2's gated-norm shape, taken right
    after the build, before any other phase has run."""
    from repro_torch.configs.registry import get_config
    cfg = get_config(SSM_ARCH)
    x, s = rmsnorm_inputs(gen, (4, cfg.ssm_d_inner))
    out = rmsnorm_vs_library(x, s, cfg.norm_eps)
    log(f"[rmsnorm fresh] (4, {cfg.ssm_d_inner}) bf16, before any other phase: "
        f"{json.dumps(out)}")


def paged_kernel_times(gen) -> dict:
    """The paged-attention entry of the kernels line: the kernel at
    danube-rag's ticks, 64 slots of 4096, 34 prefilling 64-token chunks
    beside 30 decode rows, and 64 decode rows (C = 1), beside its plain
    version and its bound. Least work: the resident K/V that some real
    row sees, read once, the chunk's real K/V and q, the real rows'
    output written; QK^T and PV over each real row's visible keys."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.paged_attention.ops import paged_attention
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    cfg = get_config(ARCH)

    def paged_at(C):
        rng = np.random.RandomState(SEED)
        args = paged_tick(gen, rng, cfg, PAGED_SLOTS, C, torch.bfloat16, mix="rag")
        W, H, K, d = (cfg.sliding_window, cfg.num_heads, cfg.num_kv_heads,
                      cfg.resolved_head_dim)
        pos, adv = (a.tolist() for a in args[6:])
        keys = rows = pairs = 0
        for p, n in zip(pos, adv):
            if n == 0:
                continue
            keys += p - max(0, p - W + 1)               # resident keys row 0 sees
            rows += n
            for j in range(n):                          # resident + chunk keys of row j
                pairs += p - max(0, p + j - W + 1) + min(j + 1, W)
        flops = 4 * d * H * pairs
        nbytes = 2 * ((keys + rows) * 2 * K * d + 2 * rows * H * d)
        t_ops, t_bytes = flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
        ref = paged_attention_ref(*(t.float() if t.is_floating_point() else t for t in args),
                                  window=W)
        err, row = paged_errs(paged_attention(*args, window=W), ref, args[-1])
        del ref
        out = {
            "max_abs_err": err, "max_row_err_over_rms": row,
            "ms": time_ms(lambda: paged_attention(*args, window=W)),
            "plain_ms": time_ms(lambda: paged_attention_ref(*args, window=W),
                                reps=5, inner=2),
            "device_ms": kernel_device_ms(lambda: paged_attention(*args, window=W),
                                          "paged_mma_kernel", n=10),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_ops_ms": 1e3 * t_ops, "bound_bytes_ms": 1e3 * t_bytes,
            "library_ms": None, "kernel": "paged_mma_kernel",
            "shape": [PAGED_SLOTS, C, H, K, d], "block_size": PAGED_BLOCK,
            "max_len": PAGED_MAX_LEN, "window": W, "dtype": "bfloat16",
            "real_rows": rows, "mean_resident": sum(pos) / len(pos), "flops": flops,
            "bytes": nbytes}
        del args
        torch.cuda.empty_cache()
        return out

    return {
        "name": "paged_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/paged_attention/csrc/paged_attention.cu",
        "replaces": None, "library_call": "none: no PyTorch call computes paged attention",
        "use": f"{ARCH} danube-rag prefill tick, 34 x 64-token chunks beside 30 decode rows",
        **paged_at(PAGED_CHUNK),
        "by_shape": [{"use": f"{ARCH} danube-rag decode tick, 64 decode rows",
                      **paged_at(1)}]}


def phase_kernel_times(gen):
    """Each kernel at its path's bf16 shapes: kernel, plain version,
    library call, and the bound. Taken before the main paths run: after
    the profile of a mamba2 serving tick (~240 k device records) the
    profiler recorded no kernel at all."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd_scan.ops import ssd_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref
    cfg, ssm_cfg = get_config(ARCH), get_config(SSM_ARCH)
    vision, audio = get_config(VISION_ARCH), get_config(AUDIO_ARCH)

    # RMSNorm at danube's serving tick (4 slots x a 16-token chunk, d_model
    # 2560), and at mamba2's, which makes most of the launches: the gated
    # norm of every ssd_decode step (4 slots, d_inner 3072) and norm1 of a
    # 16-token tick (d_model 1536, musicgen's too); internvl2's tick (896)
    shapes = [((4, 16, cfg.d_model), cfg.norm_eps),
              ((4, ssm_cfg.ssm_d_inner), ssm_cfg.norm_eps),
              ((4, 16, ssm_cfg.d_model), ssm_cfg.norm_eps),
              ((4, 16, vision.d_model), vision.norm_eps)]
    inputs = [rmsnorm_inputs(gen, shape) for shape, _ in shapes]
    # kernel and F.rms_norm in alternating windows ("ms", "library_ms" and
    # the per-round ratio's median and spread), all of them before this
    # run's first profiler session, then the gated norm's pair again after
    # the sessions that read device_ms
    pairs = [rmsnorm_vs_library(x, s, eps) for (x, s), (_, eps) in zip(inputs, shapes)]
    rms = []
    for (x, s), (shape, eps), pair in zip(inputs, shapes, pairs):
        nbytes = 2 * x.numel() * x.element_size() + s.numel() * s.element_size()
        rms.append({
            "max_abs_err": max_abs(rmsnorm(x, s, eps), rmsnorm_ref(x.float(), s, eps)),
            **pair,
            "plain_ms": time_ms(lambda: rmsnorm_ref(x, s, eps)),
            "device_ms": kernel_device_ms(lambda: rmsnorm(x, s, eps), "rmsnorm_kernel"),
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "shape": list(shape), "dtype": "bfloat16"})
    after = rmsnorm_vs_library(*inputs[1], shapes[1][1])
    log(f"[rmsnorm after profiler] {list(shapes[1][0])} bf16, after "
        f"{len(shapes)} profiler sessions: {json.dumps(after)}")
    out = [{
        "name": "rmsnorm", "route": "cuda",
        "source": "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
        "replaces": "src/repro/kernels/rmsnorm/rmsnorm.py:24",
        **rms[0],
        "by_shape": [{"use": f"{SSM_ARCH} gated norm, every ssd_decode step", **rms[1]},
                     {"use": f"{SSM_ARCH} norm1, a 16-token tick", **rms[2]},
                     {"use": f"{VISION_ARCH} norm1, a 16-token tick", **rms[3]}]}]

    # flash attention at the 2048-token prefill of danube in bf16 (the
    # tensor-core kernel) and f32 (the scalar kernel), and at hymba's
    def flash_at(B, S, H, K, d, W, dtype):
        q = torch.randn(B, S, H, d, device=DEVICE, generator=gen).to(dtype)
        k = torch.randn(B, S, K, d, device=DEVICE, generator=gen).to(dtype)
        v = torch.randn(B, S, K, d, device=DEVICE, generator=gen).to(dtype)
        pairs = sum(min(i + 1, W) if W > 0 else i + 1 for i in range(S))  # unmasked (q, k)
        flops = 4 * d * H * B * pairs
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        qt = q.transpose(1, 2).contiguous()
        if W == 0 or W >= S:      # the window does not bind: plain causal SDPA
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)
            how = "is_causal, enable_gqa"
        else:
            # the window binds: an additive band mask of q's dtype, built
            # once, and k/v repeated to H heads beforehand (kv head h // G)
            kt, vt = (t.transpose(1, 2).repeat_interleave(H // K, dim=1).contiguous()
                      for t in (k, v))
            i = torch.arange(S, device=DEVICE)
            band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
            mask = torch.zeros(S, S, device=DEVICE, dtype=dtype).masked_fill(
                ~band, float("-inf"))

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
            how = "additive band mask, k/v repeated to H heads"
        ref = attention_ref(q, k, v, causal=True, window=W)
        # the library call computes the same function (a wrong mask is off
        # by far more than one bf16 step)
        lib_err = max_abs(library().transpose(1, 2), ref)
        check(lib_err <= BF16_TOL,
              f"SDPA ({how}) at {[B, S, H, K, d]} window {W} {dtype}: {lib_err}")
        name = "flash_fwd_mma_kernel" if dtype == torch.bfloat16 else "flash_fwd_kernel"
        return {
            "max_abs_err": max_abs(flash_attention(q, k, v, True, W), ref),
            "ms": time_ms(lambda: flash_attention(q, k, v, True, W)),
            "plain_ms": time_ms(lambda: attention_ref(q, k, v, causal=True, window=W),
                                reps=9, inner=3),
            "device_ms": kernel_device_ms(lambda: flash_attention(q, k, v, True, W),
                                          name, n=5),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": time_ms(library),
            "library_call": f"scaled_dot_product_attention ({how})",
            "library_kernels": device_kernels(library)[:3],
            "library_max_abs_err": lib_err,
            "kernel": name, "shape": [B, S, H, K, d],
            "dtype": str(dtype).replace("torch.", ""), "window": W, "flops": flops}

    danube = (1, 2048, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
              cfg.sliding_window)
    hymba, arctic = get_config(HYBRID_ARCH), get_config("arctic-480b")
    out.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:86",
        **flash_at(*danube, torch.bfloat16),
        "by_shape": [
            {"use": f"{ARCH} f32 prefill (the scalar kernel)",
             **flash_at(*danube, torch.float32)},
            {"use": f"{HYBRID_ARCH} bf16 prefill, the window binds",
             **flash_at(1, 2048, hymba.num_heads, hymba.num_kv_heads,
                        hymba.resolved_head_dim, hymba.sliding_window, torch.bfloat16)},
            {"use": "arctic-480b bf16 prefill, group 7, d 128",
             **flash_at(1, 2048, arctic.num_heads, arctic.num_kv_heads,
                        arctic.resolved_head_dim, 0, torch.bfloat16)},
            {"use": f"{VISION_ARCH} bf16 prefill, group 7, d 64",
             **flash_at(1, 2048, vision.num_heads, vision.num_kv_heads,
                        vision.resolved_head_dim, 0, torch.bfloat16)},
            {"use": f"{AUDIO_ARCH} bf16 prefill, group 1 (as many kv heads as q heads)",
             **flash_at(1, 2048, audio.num_heads, audio.num_kv_heads,
                        audio.resolved_head_dim, 0, torch.bfloat16)}]})

    out.append(paged_kernel_times(gen))

    # the SSD chunk at mamba2's 2048-token prefill: x bf16, the rest f32,
    # the decays of mamba2's init. Least work: C.B^T once per chunk and,
    # per (chunk, head), (C.B^T o L).xdt on the causal triangle (j <= i)
    # and the (N, P) state. The kernels run it as 3xTF32 on tensor cores,
    # at 495 TFLOP/s: three TF32 passes for C.B^T, and for the two
    # products with x three for an f32 x but two for a bf16 x, which is
    # exact in TF32 (its small part is 0). Beside that bound, the bytes
    # alone and the f32 CUDA-core bound of the kernel's first version.
    Q, N = ssm_cfg.ssm_chunk, ssm_cfg.ssm_state
    H, P = ssm_cfg.ssm_num_heads, ssm_cfg.ssm_head_dim
    b, nc = 1, 2048 // Q
    ins = ssd_inputs(gen, b, nc, Q, N, H, P, torch.bfloat16, model_like=True)
    ab, rel = ssd_errs(ssd_chunk(*ins), ssd_chunk_ref(*ins))
    tri = Q * (Q + 1) // 2
    flops_cb = 2 * b * nc * tri * N
    flops_x = 2 * b * nc * H * (tri * P + Q * N * P)
    flops = flops_cb + flops_x
    x_passes = 2 if ins[2].dtype == torch.bfloat16 else 3
    tf32_flops = 3 * flops_cb + x_passes * flops_x
    nbytes = (sum(t.numel() * t.element_size() for t in ins)
              + 4 * b * nc * H * (Q * P + N * P + 1))         # y_diag, states, decays
    t_ops, t_bytes = tf32_flops / TF32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S
    by_kernel = kernel_device_ms_by_name(lambda: ssd_chunk(*ins), SSD_KERNELS, n=10)
    out.append({
        "name": "ssd_chunk", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_chunk.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:70",
        "max_abs_err": ab, "max_rel_err": rel,
        "ms": time_ms(lambda: ssd_chunk(*ins), reps=9, inner=5),
        "plain_ms": time_ms(lambda: ssd_chunk_ref(*ins), reps=9, inner=3),
        "device_ms": sum(by_kernel.values()), "device_ms_by_kernel": by_kernel,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "bound_note": f"3xTF32 at 495 TFLOP/s TF32: 3 passes for C.B^T, {x_passes} for "
                      f"the products with x",
        "bound_ops_ms": 1e3 * t_ops, "bound_bytes_ms": 1e3 * t_bytes,
        "bound_f32_cuda_core_ms": 1e3 * max(flops / F32_FLOPS_PER_S, t_bytes),
        "library_ms": None, "shape": [b, nc, Q, N, H, P],
        "dtype": "x bfloat16, C/B/dt/da float32", "flops": flops,
        "tf32_pass_flops": tf32_flops, "bytes": nbytes, "kernel_attrs": ssd_kernel_attrs()})
    return out


# the kernels one SSD call launches, by the names the profiler gives them
SSD_KERNELS = ("ssd_cb_kernel", "ssd_chunk_kernel")


def ssd_kernel_attrs() -> dict:
    """Registers and local memory (spills and stack) per thread of the SSD
    kernels, as the CUDA runtime reports them for the library this run
    loaded."""
    from repro_torch.kernels.ssd_scan.ssd_scan import kernel_attrs
    out = kernel_attrs()
    check(all(a["registers"] > 0 for a in out.values()), f"SSD kernel attributes: {out}")
    return out


PROFILE_SESSIONS = 3                # profiled prefills tried for one complete record


def prefill_timing(cfg, params, toks) -> dict:
    """A bf16 lm.prefill timed by CUDA events (and the host clock), then
    one more under torch.profiler: its device time, and the SSD kernels'
    share of it. Each SSD kernel must be recorded once per layer: the
    profiler on the card machine drops a contiguous run of records in a
    few percent of sessions (at the parent commit too: 2 of 40 sessions
    of this prefill lost 43 and 62 of 3 614 records), so up to
    PROFILE_SESSIONS profiled prefills are run, the first complete one is
    read, and the run fails when none is; the incomplete sessions' counts
    are returned. The launches themselves are counted exactly by the
    wrapper, apart from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        start.record()
        lm.prefill(cfg, params, {"tokens": toks}, attention_impl="kernel")
        end.record()
    end.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    ms = start.elapsed_time(end)
    incomplete = []
    for _ in range(PROFILE_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                lm.prefill(cfg, params, {"tokens": toks}, attention_impl="kernel")
            torch.cuda.synchronize()
        evs = kernel_events(prof)
        ssd = {name: [(c, us / 1e3) for k, c, us in evs if name in k]
               for name in SSD_KERNELS}
        calls = {name: sum(c for c, _ in recs) for name, recs in ssd.items()}
        if all(c == cfg.num_layers for c in calls.values()):
            break
        incomplete.append({"ssd_records": calls,
                           "device_records": sum(c for _, c, _ in evs)})
    check(len(incomplete) < PROFILE_SESSIONS,
          f"prefill profile: no session recorded every SSD launch "
          f"({cfg.num_layers} each): {incomplete}")
    device = sum(us for *_, us in evs) / 1e3
    ssd_ms = sum(us for recs in ssd.values() for _, us in recs)
    return {"tokens": toks.shape[1], "ms": ms, "wall_ms": wall,
            "incomplete_profile_sessions": incomplete,
            "profiled_device_ms": device, "ssd_device_ms": ssd_ms,
            "ssd_device_ms_by_kernel": {k: sum(us for _, us in v) for k, v in ssd.items()},
            "ssd_share_of_device": ssd_ms / device, "ssd_share_of_ms": ssd_ms / ms}


def elastic_controller(use_node_plane):
    """An ElasticController (threaded informer) on the (x=1, y=4) pod with
    model_axis 1: a (4, 1) mesh, (2, 1) on the survivors of a host."""
    from repro_torch.core import DriverRegistry, IciDriver, TpuDriver
    from repro_torch.launch.elastic import ElasticController
    from repro_torch.topology.tpu import TpuPodSpec, build_tpu_cluster
    cluster = build_tpu_cluster(1, TpuPodSpec(x=1, y=4))
    reg = DriverRegistry()
    reg.add(TpuDriver(cluster)).add(IciDriver(cluster))
    reg.run_discovery()
    return ElasticController(cluster, reg, model_axis=1, use_node_plane=use_node_plane)


def phase_elastic_ranks():
    """Phase 23(a), on this machine's CPU by design (no card runs a mesh
    that shrinks: one card holds one NCCL rank): the tier-1 test's
    elastic run without JAX. Smoke h2o-danube-1.8b in f32 from the port's
    own init (seed 0), data 8 x 32, AdamW at 1e-3, remat dots: four
    gloo ranks on the (4, 1) plan train until FaultInjector(fail_at=5)
    stops every rank, with a checkpoint at step 3; NODE_FAILED re-plans
    (2, 1) on the surviving host, and two new gloo ranks restore step 3
    onto the new mesh and train 3 more steps. Checks the stop results,
    both meshes, the resumed step, every rank's losses equal, the resumed
    step 4 equal to the failed run's, and every step's loss within 1e-4
    relative of the unsharded port's on this CPU."""
    import shutil
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import elastic
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import constant_schedule
    from repro_torch.train.train_step import StepConfig
    from repro_torch.train.trainer import Trainer
    work = os.path.join(ELASTIC_DIR, "ranks")
    shutil.rmtree(work, ignore_errors=True)
    f32 = {"param_dtype": "float32", "compute_dtype": "float32"}
    job = {"arch": ARCH, "overrides": f32, "batch": 8, "seq": 32,
           "steps": 10, "ckpt_dir": os.path.join(work, "ckpt"),
           "ckpt_every": ELASTIC_CKPT_EVERY}
    ctl = elastic_controller(False)
    try:
        t0 = time.perf_counter()
        out = elastic._train_elastic(ctl, job, work, fail_at=ELASTIC_FAIL_AT,
                                     resume_steps=3)
        seconds = time.perf_counter() - t0
        claim = (ctl.claim.allocated, ctl.claim.prepared)
    finally:
        ctl.close()
    check(out["shapes"] == [[4, 1], [2, 1]] and claim == (True, True),
          f"elastic ranks: plans {out['plans']}, claim {claim}")
    first, surv = out["first"], out["survivors"]
    check(len(first) == 4 and all(
        r["result"] == {"stopped_at": ELASTIC_FAIL_AT, "reason": "node_failure"}
        and r["world"] == 4 and r["all_dtensor"] and r["resumed_from"] is None
        and r["mesh"] == [["data", "model"], [[0], [1], [2], [3]]]
        and r["steps"] == list(range(ELASTIC_FAIL_AT)) for r in first),
        f"elastic ranks, the failed run: {first}")
    check(len(surv) == 2 and all(
        r["resumed_from"] == ELASTIC_CKPT_EVERY and r["result"]["completed"] >= 6
        and r["world"] == 2 and r["all_dtensor"]
        and r["mesh"] == [["data", "model"], [[0], [1]]] and r["steps"] == [4, 5, 6]
        for r in surv), f"elastic ranks, the survivors: {surv}")
    for runs in (first, surv):
        check(all(r["losses"] == runs[0]["losses"] for r in runs),
              "elastic ranks: the ranks' losses differ")
    check(surv[0]["losses"][0] == first[0]["losses"][4],
          "elastic ranks: the resumed step 4 is not the failed run's")
    cfg = smoke_config(ARCH).replace(**f32)
    plain = Trainer(cfg, AdamW(constant_schedule(1e-3)), SyntheticLMData(cfg, 8, 32),
                    step_cfg=StepConfig(remat="dots"), device="cpu")
    plain.init(0)
    plain.fit(7)
    want = [h["loss"] for h in plain.history]
    got = first[0]["losses"] + surv[0]["losses"][1:]
    rel = rel_diffs(got, want)
    check(len(got) == 7 and max(rel) <= 1e-4,
          f"elastic ranks vs the unsharded port: {got} vs {want} (rel {rel})")
    shutil.rmtree(work, ignore_errors=True)
    log(f"[elastic ranks] on the CPU (gloo ranks; no card runs a shrinking mesh): "
        f"{json.dumps({'plans': out['plans'], 'failed_node': out['node'], 'replan_s': out['replan_s'], 'losses': got, 'rel_to_unsharded': rel, 'seconds': seconds})}")


def phase_elastic_card():
    """Phase 23(b): h2o-danube-1.8b at full width and ELASTIC_LAYERS
    layers trains on the card under an ElasticController with the
    threaded informer and the node plane, on the (x=1, y=4) pod with
    model_axis 1 (its 4- and 2-rank meshes are not executed here: phase
    23(a) runs them). The trainer's bus is the controller's, as in the
    JAX package's end-to-end test: FaultInjector(fail_at=5) on a host of
    the plan stops fit, the controller evicts the host through its lease
    and re-plans (2, 1) on the same thread. A checkpoint at step 3 with
    ``compress_level`` ELASTIC_COMPRESS_LEVEL. Checks the stop result, the
    plan, the claim re-allocated and prepared, JOB_RESUMED published once
    with the new plan and no handler failed; then a new Trainer on the
    card resumes at step 3 and trains 2 steps, and an uninterrupted run
    trains 6: the resumed steps 4-5 are bit-equal to it, as are the failed
    run's steps 0-4. Logs NODE_FAILED to the re-planned Ready, the restore
    seconds and the checkpoint's bytes. Returns the launches: per step 2L
    flash and 4L+1 RMSNorm (remat dots), 5 + 2 + 6 steps."""
    import shutil
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs.registry import get_config
    from repro_torch.core.nri import Events
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import elastic
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import constant_schedule
    from repro_torch.train.train_step import StepConfig
    from repro_torch.train.trainer import FaultInjector, Trainer
    cfg = get_config(ARCH).replace(num_layers=ELASTIC_LAYERS)
    work = os.path.join(ELASTIC_DIR, "card")
    shutil.rmtree(work, ignore_errors=True)
    data = SyntheticLMData(cfg, 8, 64)
    sc = StepConfig(remat="dots", attention_impl="kernel")
    manager = ckpt.CheckpointManager(work, compress_level=ELASTIC_COMPRESS_LEVEL)

    def trainer(**kw):
        return Trainer(cfg, AdamW(constant_schedule(1e-3)), data, step_cfg=sc,
                       device=DEVICE, **kw)

    marks, resumed_events = {}, []
    ctl = elastic_controller(True)
    try:
        plan = ctl.plan_mesh()
        check(plan.axis_shape == (4, 1), f"elastic card: first plan {plan.summary()}")
        node = elastic._plan_host(ctl, plan)
        failed = trainer(ckpt=manager, ckpt_every=ELASTIC_CKPT_EVERY,
                         drivers=[FaultInjector(fail_at=ELASTIC_FAIL_AT, node=node)])
        ctl.registry.bus = failed.bus
        failed.bus.subscribe(Events.NODE_FAILED,
                             lambda e: marks.setdefault("failed", time.perf_counter()),
                             "chip_smoke")
        failed.bus.subscribe(Events.NODE_FAILED, ctl.on_node_failed, "elastic")
        failed.bus.subscribe(Events.JOB_RESUMED, lambda e: (
            resumed_events.append(e.context),
            marks.setdefault("ready", time.perf_counter())), "chip_smoke")
        failed.init(SEED)
        out = failed.fit(10)
        manager.wait()
        check(out == {"stopped_at": ELASTIC_FAIL_AT, "reason": "node_failure"},
              f"elastic card: fit returned {out}")
        check(not failed.bus.failures(),
              f"elastic card: a handler failed: {failed.bus.failures()}")
        check(ctl.mesh_shape == (2, 1) and node not in ctl.registry.pool.nodes(),
              f"elastic card: re-planned {ctl.mesh_shape}, pool {ctl.registry.pool.nodes()}")
        check(ctl.claim.allocated and ctl.claim.prepared,
              "elastic card: the claim was not re-allocated and prepared")
        check(len(resumed_events) == 1 and resumed_events[0]["plan"].axis_shape == (2, 1)
              and resumed_events[0]["reason"] == f"lost {node}",
              f"elastic card: JOB_RESUMED {resumed_events}")
        events = list(ctl.events)
    finally:
        ctl.close()
    failed_losses = [h["loss"] for h in failed.history]
    del failed
    free_cuda()
    step_dir = os.path.join(work, f"step_{ELASTIC_CKPT_EVERY:08d}")
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    resumed = trainer(ckpt=manager)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = resumed.resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(step == ELASTIC_CKPT_EVERY, f"elastic card: resumed at step {step}")
    resumed.fit(2)
    got = [(h["step"], h["loss"]) for h in resumed.history]
    del resumed
    free_cuda()
    whole = trainer()
    whole.init(SEED)
    whole.fit(6)
    want = [h["loss"] for h in whole.history]
    del whole
    free_cuda()
    check(got == [(4, want[4]), (5, want[5])] and failed_losses == want[:5],
          f"elastic card: resumed {got}, failed {failed_losses}, uninterrupted {want}")
    report = {"arch": cfg.name, "layers": ELASTIC_LAYERS, "params": cfg.param_count(),
              "failed_node": node, "events": events,
              "node_failed_to_ready_ms": 1e3 * (marks["ready"] - marks["failed"]),
              "restore_s": restore_s, "codec": manifest["codec"],
              "compress_level": ELASTIC_COMPRESS_LEVEL,
              "disk_bytes": os.path.getsize(os.path.join(step_dir, ckpt.SHARD)),
              "losses_failed": failed_losses, "losses_resumed": got,
              "losses_uninterrupted": want}
    shutil.rmtree(work, ignore_errors=True)
    log(f"[elastic card] {json.dumps(report)}")
    steps = ELASTIC_FAIL_AT + 2 + 6
    L = ELASTIC_LAYERS
    return {"flash_attention": steps * 2 * L, "paged_attention": 0, "ssd_chunk": 0,
            "rmsnorm": steps * (4 * L + 1)}


def legacy_ticks(eng) -> int:
    """A legacy engine's ticks: one decode_step, and one clock step, each."""
    return int(eng.cache["pos"])


def phase_legacy_f32(rng):
    """Phase 24, f32: danube at full width and LEGACY_F32_LAYERS layers.
    The legacy engine's first-token logits for a 64-token prompt (fed
    token by token) vs lm.prefill's last-position logits (dense
    attention), rel <= 2e-3 (``tests/test_decode.py:46``), and its first
    greedy token. Returns the launches: 3L+1 RMSNorm for the prefill, 2L+1
    per engine tick."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serve.legacy import LegacyServeEngine
    cfg = get_config(ARCH).replace(num_layers=LEGACY_F32_LAYERS, param_dtype="float32",
                                   compute_dtype="float32")
    params = lm.init_params(cfg, SEED, DEVICE)
    S = 64
    prompt = rng.randint(0, cfg.vocab_size, size=S).tolist()
    with torch.no_grad():
        lk, _ = lm.prefill(cfg, params, {"tokens": torch.tensor([prompt], device=DEVICE)},
                           attention_impl="dense")
        eng = LegacyServeEngine(cfg, params, batch_slots=2, max_len=S + 16, seed=SEED,
                                device=DEVICE)
        seen = []
        decode = eng._decode

        def captured(*args):
            logits, cache = decode(*args)
            seen.append(logits)
            return logits, cache

        eng._decode = captured
        r = eng.submit(prompt, max_new_tokens=4)
        eng.run()
    err = rel_err(seen[S - 1][0, 0], lk[0, 0])
    check(r.done and err <= 2e-3,
          f"legacy f32: first-token logits vs prefill rel err {err} > 2e-3")
    check(r.generated[0] == int(lk[0, 0].argmax()), "legacy f32: first greedy token differs")
    ticks = legacy_ticks(eng)
    log(f"[legacy f32] {cfg.num_layers} layers: first-token logits vs lm.prefill rel err "
        f"{err:.3g}; {ticks} ticks")
    del params, eng, seen
    free_cuda()
    L = cfg.num_layers
    return {"flash_attention": 0, "paged_attention": 0, "ssd_chunk": 0,
            "rmsnorm": 3 * L + 1 + ticks * (2 * L + 1)}


def phase_legacy_bf16(rng):
    """Phase 24, bf16: danube at full width and depth on the legacy
    engine alone. (1) The recycled-slot bug's runs: through one slot, a
    48-token request A then an 8-token request B, and B alone through a
    fresh legacy engine; B's first-token logits of both. (2)
    ``submit([])`` is accepted and ``run()`` raises IndexError. (3)
    ``run(max_steps=3)`` with two 20-token requests on one slot returns
    []. (4) The baseline's legacy arm: LEGACY_REQUESTS requests (prompts
    of 16-64 tokens, 16 new, 4 slots). Returns the launches, 2L+1 RMSNorm
    per legacy tick, and what :func:`phase_legacy_vs_serve` compares."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.serve.legacy import LegacyServeEngine
    cfg = get_config(ARCH)
    check(cfg.param_dtype == "bfloat16", "the legacy engine serves danube in bf16")
    params = lm.init_params(cfg, SEED, DEVICE)
    a = rng.randint(0, cfg.vocab_size, size=48).tolist()
    b = rng.randint(0, cfg.vocab_size, size=8).tolist()
    ticks = 0

    def legacy(slots, max_len=128):
        return LegacyServeEngine(cfg, params, batch_slots=slots, max_len=max_len,
                                 seed=SEED, device=DEVICE)

    def legacy_first(eng, prompt_ticks):
        """Run a one-slot legacy engine; the logits of its tick
        ``prompt_ticks - 1``, where the last request's first token is
        sampled."""
        seen = []
        decode = eng._decode

        def captured(*args):
            logits, cache = decode(*args)
            seen.append(logits)
            return logits, cache

        eng._decode = captured
        eng.run()
        return seen[prompt_ticks - 1][0, 0].float()

    with torch.no_grad():
        rec = legacy(1)
        ra = rec.submit(a, max_new_tokens=8)
        rb = rec.submit(b, max_new_tokens=8)
        b_recycled = legacy_first(rec, len(a) + 8 - 1 + len(b))
        ticks += legacy_ticks(rec)
        fresh_leg = legacy(1)
        fresh_leg.submit(b, max_new_tokens=1)
        b_fresh_legacy = legacy_first(fresh_leg, len(b))
        ticks += legacy_ticks(fresh_leg)
    check(ra.done and rb.done, "legacy bf16: a request did not complete")

    empty = legacy(2)
    r = empty.submit([], max_new_tokens=4)
    check(empty.pending == [r], "legacy bf16: submit([]) was not accepted")
    try:
        with torch.no_grad():
            empty.run()
        raised = False
    except IndexError:
        raised = True
    check(raised, "legacy bf16: run() after submit([]) did not raise IndexError")
    ticks += legacy_ticks(empty)

    capped = legacy(1)
    capped.submit(a, max_new_tokens=20)
    capped.submit(b, max_new_tokens=20)
    with torch.no_grad():
        got = capped.run(max_steps=3)
    check(got == [] and legacy_ticks(capped) == 3,
          f"legacy bf16: run(max_steps=3) returned {got}")
    ticks += legacy_ticks(capped)

    lens = rng.randint(16, 65, size=LEGACY_REQUESTS)
    prompts = [rng.randint(0, cfg.vocab_size, size=int(n)).tolist() for n in lens]
    eng = legacy(4)
    base = baseline_arm(eng, prompts, legacy_ticks, "legacy")
    ticks += base["ticks"]
    run = {"cfg": cfg, "params": params, "a": a, "b": b, "lens": lens, "prompts": prompts,
           "b_recycled": b_recycled, "b_fresh_legacy": b_fresh_legacy,
           "recycled_b_tokens": rb.generated, "legacy": base}
    return {"flash_attention": 0, "paged_attention": 0, "ssd_chunk": 0,
            "rmsnorm": ticks * norms_per_tick(cfg, 1)}, run


def baseline_arm(eng, prompts, ticks_of, name):
    """One arm of the legacy baseline (no claim): ``prompts``, 16 new
    tokens each, through ``eng``; its ticks, wall seconds and tokens/s."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(all(q.done for q in reqs), f"legacy bf16: {name} left a request unfinished")
    n = ticks_of(eng)
    gen = sum(len(q.generated) for q in reqs)
    return {"ticks": n, "wall_s": wall, "generated_tokens": gen,
            "tokens_per_s": gen / wall, "ms_per_tick": 1e3 * wall / n}


def phase_legacy_vs_serve(run):
    """Phase 24, the ServeEngine (chunk 16) beside the legacy engine, on
    phase_legacy_bf16's weights and prompts: B alone through a fresh
    ServeEngine, A then B through one recycled slot, and the baseline's
    load on 4 slots. The legacy engine's recycled B must be further than
    3x the two fresh paths' bf16 difference from the fresh ServeEngine's
    first-token logits, and the ServeEngine's recycled slot must give B
    its fresh tokens. Logs both arms of the baseline: one run each at a
    toy load, no claim. Returns the launches, 2L+1 RMSNorm per
    ServeEngine tick."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    cfg, params, a, b = run["cfg"], run["params"], run["a"], run["b"]

    def serve(slots, max_len=128):
        return ServeEngine(cfg, params, batch_slots=slots, max_len=max_len,
                           prefill_chunk=16, seed=SEED, device=DEVICE)

    with torch.no_grad():
        fresh = serve(1)
        seen = []
        capture_logits(fresh, seen)
        fb = fresh.submit(b, max_new_tokens=8)
        fresh.run()
        b_fresh = seen[0][0, len(b) - 1].float()
        recycled = serve(1)
        sa = recycled.submit(a, max_new_tokens=8)
        sb = recycled.submit(b, max_new_tokens=8)
        recycled.run()
    ticks = fresh.steps + recycled.steps
    base = baseline_arm(serve(4), run["prompts"], lambda e: e.steps, "serve_engine")
    ticks += base["ticks"]
    noise = rel_err(run["b_fresh_legacy"], b_fresh)
    contaminated = rel_err(run["b_recycled"], b_fresh)
    check(fb.done and sa.done and sb.done, "legacy bf16: a ServeEngine request did not complete")
    check(contaminated > 3 * noise,
          f"legacy bf16: recycled-slot B's first-token logits vs a fresh ServeEngine: "
          f"rel err {contaminated}, not above 3x the paths' bf16 difference {noise}")
    check(sb.generated == fb.generated,
          f"legacy bf16: the ServeEngine's recycled slot changed B's tokens "
          f"{sb.generated} vs {fb.generated}")
    report = {"arch": cfg.name, "layers": cfg.num_layers,
              "recycled_b_first_token_rel_err": contaminated,
              "fresh_paths_rel_err": noise,
              "recycled_b_tokens": run["recycled_b_tokens"], "fresh_b_tokens": fb.generated,
              "baseline_one_run_each_no_claim": {
                  "requests": LEGACY_REQUESTS, "prompt_lens": [int(n) for n in run["lens"]],
                  "new_tokens": 16, "slots": 4, "prefill_chunk": 16,
                  "legacy": run["legacy"], "serve_engine": base}}
    log(f"[legacy bf16] {json.dumps(report)}")
    run.clear()
    del params
    free_cuda()
    return {"flash_attention": 0, "paged_attention": ticks * paged_per_tick(cfg),
            "ssd_chunk": 0, "rmsnorm": ticks * norms_per_tick(cfg, 1)}


DRYRUN_LAYERS = 2                  # [dryrun card]: danube at full width, 2 of 24 layers
DRYRUN_BATCH, DRYRUN_SEQ = 8, 64
DRYRUN_MEM_REL = 0.10              # the trace's peak vs max_memory_allocated
DRYRUN_BYTES_REL = 0.02            # the trace's bytes vs the card's (the plain RMSNorm's copies)


def phase_dryrun_card():
    """[dryrun card]: the dry run's roofline held against the card.
    (1) The card's dense bf16 matmul rate and HBM bytes/s
    (``roofline.measure.measure_constants``), each at or below the H100
    SXM5 data sheet, the rates of the roofline's ``H100`` (a reading
    above it is a measurement fault). (2) ``lower_cell("h2o-danube-1.8b",
    "train_4k")`` on a fake 16 x 16 process group, on this machine's CPU
    and torch: status ok, its roofline on the data sheet (the bound) and
    at the measured rates. (3) danube at full width and DRYRUN_LAYERS
    layers, one AdamW step of DRYRUN_BATCH x DRYRUN_SEQ, remat full, dense
    attention, no mesh (``launch.dryrun.card_step``): traced on fake
    tensors, then run on the card under the same counter: matmul FLOPs
    equal, bytes within DRYRUN_BYTES_REL (the trace runs RMSNorm's plain
    version, the card its kernel), the trace's peak within DRYRUN_MEM_REL
    of ``max_memory_allocated``, and the step's device time (profiled)
    at least the roofline's bound. Returns the RMSNorm launches: 6 steps
    (warm-up, counted, 3 timed, profiled) of 4L+1 each (remat full reruns
    the layer bodies' norms)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.dryrun import card_step, lower_cell
    from repro_torch.roofline.analysis import H100, roofline_terms
    from repro_torch.roofline.measure import DATASHEET, measure_constants, spec_from

    card = gpu_line()
    measured = measure_constants()
    log(f"[dryrun card] constants ({card}): {json.dumps(measured)}; "
        f"data sheet {json.dumps(DATASHEET)}")
    for key, sheet in DATASHEET.items():
        check(measured[key] <= sheet, f"[dryrun card] {key} {measured[key]:.4g} above the "
                                      f"data sheet's {sheet:.4g}: a measurement fault")
    at_rates = spec_from(measured, card)

    t0 = time.perf_counter()
    rec = lower_cell(ARCH, "train_4k")
    trace_s = time.perf_counter() - t0
    check(rec["status"] == "ok", f"[dryrun card] lower_cell: {rec}")
    for hw in (H100, at_rates):
        r = roofline_terms(rec, hw=hw)
        log(f"[dryrun card] {ARCH} train_4k {rec['mesh']} on {hw.name} (torch "
            f"{torch.__version__}, {trace_s:.1f} s on the host): compute={r.compute_s:.4f}s "
            f"memory={r.memory_s:.4f}s collective={r.collective_s:.4f}s "
            f"dominant={r.dominant} mfu<={r.mfu_bound() * 100:.2f}% "
            f"useful={r.useful_ratio * 100:.1f}% mem={r.per_device_gib:.3f}GiB "
            f"flops={rec['flops']:.6g} bytes={rec['hlo_bytes']:.6g} "
            f"collectives={json.dumps(rec['collectives_by_axis'])}")

    cfg = get_config(ARCH).replace(num_layers=DRYRUN_LAYERS)
    out = card_step(cfg, DRYRUN_BATCH, DRYRUN_SEQ, seed=SEED)
    pred, got = out["predicted"], out["card"]
    bound_ms = 1e3 * out["roofline"]["step_time_s"]
    mem_rel = abs(pred["peak_bytes"] - got["max_memory_allocated_bytes"]) / \
        got["max_memory_allocated_bytes"]
    log(f"[dryrun card] danube {DRYRUN_LAYERS}L {DRYRUN_BATCH}x{DRYRUN_SEQ}: "
        f"{json.dumps({**out, 'device_over_bound': out['device_ms_per_step'] / bound_ms, 'step_over_bound': out['step_ms'] / bound_ms, 'memory_rel': mem_rel})}")
    check(math.isfinite(out["loss"]), f"[dryrun card] loss {out['loss']}")
    check(got["flops"] == pred["flops"] and pred["flops"] > 0,
          f"[dryrun card] matmul FLOPs: card {got['flops']} vs trace {pred['flops']}")
    check(got["bytes_rel"] <= DRYRUN_BYTES_REL,
          f"[dryrun card] bytes: trace {pred['bytes']} vs card {got['bytes']} "
          f"({got['bytes_rel']:.4f} > {DRYRUN_BYTES_REL}); by op {got['bytes_by_op_diff']}")
    check(mem_rel <= DRYRUN_MEM_REL,
          f"[dryrun card] peak: trace {pred['peak_bytes']} vs max_memory_allocated "
          f"{got['max_memory_allocated_bytes']} ({mem_rel:.3f} > {DRYRUN_MEM_REL})")
    check(out["device_ms_per_step"] >= bound_ms,
          f"[dryrun card] the step's device time {out['device_ms_per_step']:.3f} ms below "
          f"the roofline's bound {bound_ms:.3f} ms")
    return {"flash_attention": 0, "paged_attention": 0, "ssd_chunk": 0,
            "rmsnorm": 6 * (4 * cfg.num_layers + 1)}


def kernels_line(times, paths):
    """The kernel entries with their launches: ``paths`` holds each main
    path's launch counts, and a kernel's ``launches`` is their sum."""
    return [{**e, "launches": sum(c[e["name"]] for c in paths.values()),
             "launches_by_path": {path: c[e["name"]] for path, c in paths.items()}}
            for e in times]


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
    timed("build", phase_build)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    timed("rmsnorm fresh", phase_rmsnorm_fresh, gen)
    timed("rmsnorm", phase_rmsnorm, gen)
    timed("flash", phase_flash, gen)
    timed("ssd", phase_ssd, gen)
    timed("paged", phase_paged, gen)
    times = timed("kernel times", phase_kernel_times, gen)

    rng = np.random.RandomState(SEED)
    paths = {}
    reset_launch_counts()                      # the dense path: phases 5-6
    f32_ticks = timed("model f32", phase_model_f32, rng)
    cfg, params, _, stats = timed("serve bf16 " + ARCH, phase_serve_bf16, rng, ARCH)
    paths["dense"] = launch_counts()
    log(f"[dense path] kernel launches in phases 5-6: {paths['dense']}")
    # one flash launch per layer in each of the f32 and bf16 prefills, one
    # paged launch per layer and serving tick; the RMSNorm launches of the
    # serving ticks are checked in phase 6
    want_flash = 2 * cfg.num_layers
    want_paged = (f32_ticks + stats["ticks"]) * paged_per_tick(cfg)
    check(paths["dense"]["flash_attention"] == want_flash
          and paths["dense"]["paged_attention"] == want_paged
          and paths["dense"]["ssd_chunk"] == 0 and paths["dense"]["rmsnorm"] > 0,
          f"dense path launches {paths['dense']}: want {want_flash} flash, "
          f"{want_paged} paged, no SSD")
    timed("paged tick " + ARCH, phase_paged_tick, cfg, params)
    timed("profile " + ARCH, phase_profile, cfg, params, rng)
    # the plane cost path: danube's weights again, served under the four
    # arms; RMSNorm's launches, 2L+1 per engine tick, counted exactly
    reset_launch_counts()
    want = timed("plane cost", phase_plane_cost, cfg, params)
    paths["plane_cost"] = launch_counts()
    log(f"[plane cost path] kernel launches: {paths['plane_cost']}")
    check(paths["plane_cost"] == want,
          f"plane cost path launches {paths['plane_cost']} != {want}")
    del params
    torch.cuda.empty_cache()

    # the moe path: phases 7, 7b and 7c, all of it counted exactly: per
    # kernel prefill L flash and 3L+1 RMSNorm, per serving tick 2L+1
    reset_launch_counts()
    want = [timed("moe f32", phase_moe_f32, rng)]
    for arch in ("grok-1-314b", "arctic-480b"):   # arctic last: its profile follows
        cfg, params, _, stats = timed(f"serve bf16 {arch}", phase_serve_bf16, rng, arch,
                                      MOE_DEPTH[arch])
        want.append(add_launches(kernel_prefill_launches(cfg),
                                 {"flash_attention": 0,
                                  "paged_attention": stats["ticks"] * paged_per_tick(cfg),
                                  "ssd_chunk": 0,
                                  "rmsnorm": stats["ticks"] * norms_per_tick(cfg, 1)}))
        if arch != "arctic-480b":
            del params
            torch.cuda.empty_cache()
    paths["moe"] = launch_counts()
    log(f"[moe path] kernel launches in phases 7-7c: {paths['moe']}")
    check(paths["moe"] == add_launches(*want),
          f"moe path launches {paths['moe']} != {add_launches(*want)}")
    timed("profile arctic-480b", phase_profile, cfg, params, rng)
    del params
    torch.cuda.empty_cache()

    # the hybrid path: phase 10's f32 kernel prefill, then hymba's bf16
    # prefill and serving (the first CUDA run of its paged decode_chunk)
    reset_launch_counts()
    timed("hybrid f32", phase_hybrid_f32, rng)
    hcfg, params, _, stats = timed("serve bf16 " + HYBRID_ARCH, phase_serve_bf16, rng,
                                   HYBRID_ARCH)
    paths["hybrid"] = launch_counts()
    log(f"[hybrid path] kernel launches in phases 10-10b: {paths['hybrid']}")
    # per prefill: L SSD and 4L+1 RMSNorm (norm1 for the cache's K/V,
    # norm1, the gated norm, norm2; the final norm), and L flash with the
    # kernel; three prefills: f32 with the kernel and with dense attention,
    # bf16 with the kernel. The serving ticks' RMSNorm launches are checked
    # in phase 10b
    L = hcfg.num_layers
    want_h = {"flash_attention": 2 * L,
              "paged_attention": stats["ticks"] * paged_per_tick(hcfg), "ssd_chunk": 3 * L,
              "rmsnorm": 3 * (4 * L + 1) + stats["rmsnorm_launches_serving"]}
    check(paths["hybrid"] == want_h, f"hybrid path launches {paths['hybrid']} != {want_h}")
    del params
    torch.cuda.empty_cache()

    # the vision and audio paths: phases 12-12b and 13-13b, each counted
    # exactly: its f32 phase (from the structure) and its serving phase's
    # kernel prefill (L flash, 3L+1 RMSNorm) and ticks (2L+1 RMSNorm each,
    # checked in the phase); then the profile of each one's serving ticks
    for path, arch in (("vision", VISION_ARCH), ("audio", AUDIO_ARCH)):
        reset_launch_counts()
        want_f = timed(f"{path} f32", phase_frontend_f32, rng, arch)
        fcfg, params, _, stats = timed(f"serve bf16 {arch}", phase_serve_bf16, rng, arch,
                                       None, FRONTEND_REQUESTS)
        paths[path] = launch_counts()
        want = add_launches(want_f, kernel_prefill_launches(fcfg),
                            {"flash_attention": 0,
                             "paged_attention": stats["ticks"] * paged_per_tick(fcfg),
                             "ssd_chunk": 0, "rmsnorm": stats["rmsnorm_launches_serving"]})
        log(f"[{path} path] kernel launches: {paths[path]}")
        check(paths[path] == want, f"{path} path launches {paths[path]} != {want}")
        timed(f"profile {arch}", phase_profile, fcfg, params, rng)
        del params
        torch.cuda.empty_cache()

    # the train path: phase 14 (f32 gradients) and 14b (bf16 steps at full
    # size), counted exactly, remat's recompute launches included
    reset_launch_counts()
    want = [timed("train f32", phase_train_f32), timed("train bf16", phase_train_bf16)]
    paths["train"] = launch_counts()
    log(f"[train path] kernel launches: {paths['train']}")
    check(paths["train"] == add_launches(*want),
          f"train path launches {paths['train']} != {add_launches(*want)}")

    # the trainer path: phase 15 (the train launcher at full size),
    # counted exactly, remat's recompute launches included
    reset_launch_counts()
    want = timed("train launcher", phase_train_launcher)
    paths["trainer"] = launch_counts()
    log(f"[trainer path] kernel launches: {paths['trainer']}")
    check(paths["trainer"] == want,
          f"trainer path launches {paths['trainer']} != {want}")

    reset_launch_counts()                      # the ssm path: phases 8-9
    timed("ssm f32", phase_ssm_f32, rng)
    ssm_cfg, params, prefill, _ = timed("serve bf16 " + SSM_ARCH, phase_serve_bf16, rng,
                                        SSM_ARCH)
    paths["ssm"] = launch_counts()
    log(f"[ssm path] kernel launches in phases 8-9: {paths['ssm']}")
    # mamba2 is attention-free; one SSD launch per layer in each of the
    # f32 prefill and the three bf16 prefills (checked, timed by events,
    # profiled: prefill_timing adds the last two, and one more per profiled
    # session it had to repeat), and one for the layer-0 check on the card
    want_ssd = ((4 + len(prefill["incomplete_profile_sessions"])) * ssm_cfg.num_layers
                + 1)
    check(paths["ssm"]["flash_attention"] == 0 and paths["ssm"]["rmsnorm"] > 0
          and paths["ssm"]["paged_attention"] == 0
          and paths["ssm"]["ssd_chunk"] == want_ssd,
          f"ssm path launches {paths['ssm']}: want no flash, {want_ssd} SSD")
    # last: after the profile of a mamba2 tick (~240 k device records) the
    # profiler recorded no kernel at all in a later session
    timed("profile " + SSM_ARCH, phase_profile, ssm_cfg, params, rng)
    del params
    torch.cuda.empty_cache()

    # the mesh path, after every profile (it needs none, and no process
    # group exists while the profiler records): phase 17 plans a 1 x 1
    # mesh through the KND core; phase 18 trains danube at full size on it
    # and without it, each run's launches set to 0 just before it and read
    # just after (in the phase); phase 19 takes the int8 pod mean of the
    # mesh run's gradients
    plan = timed("mesh plan", phase_mesh_plan)
    with nccl_group():
        from repro_torch.core import MeshRuntime
        mesh = MeshRuntime().execute(plan.attachment())
        runs, grads = timed("mesh train", phase_mesh_train, mesh)
        timed("pod mean", phase_pod_mean, grads)
        del grads, mesh
    paths["mesh"] = add_launches(*runs.values())
    log(f"[mesh path] kernel launches: {paths['mesh']} ({runs})")
    torch.cuda.empty_cache()

    # the mesh families path: phase 22 on phase 17's plan over a new NCCL
    # group, the SSD chunk on DTensors and then every family but dense
    # trained on the mesh and without, each run's launches set to 0 just
    # before it and read just after (in the phase)
    with nccl_group():
        from repro_torch.core import MeshRuntime
        mesh = MeshRuntime().execute(plan.attachment())
        runs = timed("mesh families", phase_mesh_families, mesh)
        del mesh
    paths["mesh_families"] = add_launches(*runs.values())
    log(f"[mesh families path] kernel launches: {paths['mesh_families']} ({runs})")

    # the declarative paths, after the mesh path (they open and destroy
    # process groups of their own): phase 20 serves danube from a
    # reconciled replica set; phase 21 trains it on a mesh the
    # AttachmentController built, and phase 16 round-trips a checkpoint of
    # the sharded state through the same launcher; each path's launches
    # set to 0 just before it and checked exactly just after
    reset_launch_counts()
    want = timed("knd serve", phase_knd_serve)
    paths["knd_serve"] = launch_counts()
    log(f"[knd serve path] kernel launches: {paths['knd_serve']}")
    check(paths["knd_serve"] == want,
          f"knd serve path launches {paths['knd_serve']} != {want}")
    reset_launch_counts()
    want = [timed("knd train", phase_knd_train), timed("checkpoint", phase_checkpoint)]
    paths["knd_train"] = launch_counts()
    log(f"[knd train path] kernel launches: {paths['knd_train']}")
    check(paths["knd_train"] == add_launches(*want),
          f"knd train path launches {paths['knd_train']} != {add_launches(*want)}")

    # the elastic path: phase 23, (a) on the CPU's gloo ranks (no launch),
    # (b) danube's failed, resumed and uninterrupted runs on the card
    reset_launch_counts()
    timed("elastic ranks (cpu)", phase_elastic_ranks)
    want = timed("elastic card", phase_elastic_card)
    paths["elastic"] = launch_counts()
    log(f"[elastic path] kernel launches: {paths['elastic']}")
    check(paths["elastic"] == want, f"elastic path launches {paths['elastic']} != {want}")

    # the legacy path: phase 24, the legacy engine's f32 check and its
    # bf16 runs at full size, 2L+1 RMSNorm per legacy tick
    reset_launch_counts()
    want = [timed("legacy f32", phase_legacy_f32, rng)]
    launches, legacy_run = timed("legacy bf16", phase_legacy_bf16, rng)
    want.append(launches)
    paths["legacy"] = launch_counts()
    log(f"[legacy path] kernel launches: {paths['legacy']}")
    check(paths["legacy"] == add_launches(*want),
          f"legacy path launches {paths['legacy']} != {add_launches(*want)}")

    # the ServeEngine beside the legacy engine (phase 24's comparison):
    # its own counts, 2L+1 RMSNorm per ServeEngine tick
    reset_launch_counts()
    want = timed("legacy vs serve engine", phase_legacy_vs_serve, legacy_run)
    paths["legacy_vs_serve"] = launch_counts()
    log(f"[legacy vs serve path] kernel launches: {paths['legacy_vs_serve']}")
    check(paths["legacy_vs_serve"] == want,
          f"legacy vs serve path launches {paths['legacy_vs_serve']} != {want}")

    # the dryrun path: phase 25, the dry run's counts against the card;
    # RMSNorm through its autograd wrapper in the real steps
    reset_launch_counts()
    want = timed("dryrun card", phase_dryrun_card)
    paths["dryrun"] = launch_counts()
    log(f"[dryrun path] kernel launches: {paths['dryrun']}")
    check(paths["dryrun"] == want, f"dryrun path launches {paths['dryrun']} != {want}")

    for e in times:
        if e["name"] == "ssd_chunk":
            e[f"{SSM_ARCH}_prefill_bf16"] = prefill
    kernels = kernels_line(times, paths)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

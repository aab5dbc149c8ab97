"""Multi-pod dry run: trace every (arch x shape x mesh) cell on fake tensors.

The port of the JAX package's ``launch/dryrun.py``. Where JAX lowers and
compiles each cell through XLA against 512 fake CPU devices, this traces
one step of it, eagerly, on one rank of a fake process group of the
plan's world size (256, or 512 with ``--multi-pod``):

  * the mesh comes from the KND path (``make_planned_mesh`` /
    ``planned_mesh_for`` on ``device_type="cpu"``), a ``DeviceMesh`` over
    the fake group, and the sharding rules are the JAX package's;
  * the parameters, optimizer state, batch and cache are ``DTensor``s of
    fake tensors placed by those rules (``FakeTensorMode``: shapes,
    dtypes and placements, no memory), and the train, prefill or decode
    step runs on them once;
  * ``roofline/counters.py`` counts what this rank ran: FLOPs, bytes,
    collective bytes by kind and mesh axis, peak live storage bytes.

It is a host tool: nothing is allocated on any device, and no
environment variable is set. Like JAX's dry run, which traces the jnp
paths (``attention_impl="auto"``), it traces the plain PyTorch versions
of the kernels (its tensors are CPU tensors). As JAX's, it traces 1 and
2 layers and extrapolates FLOPs, bytes and collectives to the full depth
(exact for a uniform stack: fixed + L x per layer); it extrapolates
memory the same way (``memory_method``), which the tests hold against a
full-depth trace. ``hlo_bytes`` keeps JAX's key and holds the counter's
bytes: the eager path's operand and result traffic, not a fused module's.

``card_step`` is the one function here that runs on a card: it holds one
unsharded step's trace against the same step run there (``chip_smoke.py``'s
``[dryrun card]`` phase and the card tests).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import statistics
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import SHAPES, ShapeSpec, cache_specs, input_specs, shape_applicable
from ..configs.registry import ARCHS, get_config
from ..models import lm
from ..models.config import ModelConfig
from ..parallel.sharding import (ShardingRules, batch_placements, logical_to_pspec,
                                 param_shardings, placements, use_rules)
from ..roofline.analysis import H100, HardwareSpec, roofline_terms
from ..roofline.counters import (StepCounter, collective_bytes_by_axis_kind,
                                 collective_bytes_by_kind, storage_bytes, tensors_of)
from ..train.optimizer import Adafactor, AdamW
from ..train.schedule import cosine_schedule
from ..train.train_step import (StepConfig, abstract_train_state, init_train_state,
                                make_train_step, train_state_specs)
from ..tree import tree_map
from .mesh import make_planned_mesh

__all__ = ["BIG_MODEL_PARAMS", "ARCH_RULES", "ARCH_MICROBATCHES", "pick_optimizer",
           "batch_shardings", "cache_shardings", "fake_group", "lower_cell",
           "card_step", "run_all", "main"]

BIG_MODEL_PARAMS = 60e9   # adafactor above this (HBM), adamw below

# Per-arch sharding-rule overrides (the parallelism config system).
# grok-1: 8 experts cannot shard over model=16. Keep expert weights
# STATIONARY (fully sharded over data x model on the FFN dim) so no
# FSDP gather of 38 GiB/layer ever happens; shard the dispatch
# buffers' capacity dim over data.
ARCH_RULES: Dict[str, Dict[str, Any]] = {
    "grok-1-314b": {"experts": None, "expert_embed": None,
                    "expert_ffn": ("data", "model"),
                    "act_experts": None, "moe_cap": "data"},
}

# Baseline gradient-accumulation factors (the JAX package's: chosen there
# so the train_4k cell's activations fit its chips; global batch stays 256).
ARCH_MICROBATCHES: Dict[str, int] = {
    "arctic-480b": 8, "grok-1-314b": 8, "yi-34b": 4, "qwen1.5-110b": 8,
    "phi3-medium-14b": 2, "musicgen-medium": 2, "internvl2-1b": 1,
}


def pick_optimizer(cfg: ModelConfig):
    lr = cosine_schedule(3e-4, 2000, 100_000)
    if cfg.param_count() >= BIG_MODEL_PARAMS:
        return Adafactor(lr)
    return AdamW(lr)


def batch_shardings(specs: Dict[str, Any], rules: ShardingRules):
    """Each input's placements: its leading dim over ``"batch"``."""
    return tree_map(lambda s: batch_placements(s, rules), specs)


def cache_shardings(cache_abs: Any, rules: ShardingRules):
    """KV cache (L,B,S,K,hd): batch on dim1, kv heads on dim3; SSD state
    (L,B,H,N,P): batch dim1; conv (L,B,k,C): batch dim1 (``lm.cache_axes``;
    ``pos`` replicated)."""
    out = tree_map(lambda s: placements(logical_to_pspec(lm.cache_axes(tuple(s.shape)), rules, s.shape),
                                        rules.mesh), cache_abs)
    out["pos"] = placements((None,), rules.mesh)
    return out


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the span of the block (none is made if one is initialised)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        yield
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake_like(tree: Any, shardings: Any, mesh: Any) -> Any:
    """Fake ``DTensor``s shaped as ``tree``'s (meta) tensors, placed by
    ``shardings``, made shard by shard; plain fake tensors without a mesh."""
    from torch.distributed.tensor import empty as dt_empty
    if mesh is None:
        return tree_map(lambda a: torch.empty(tuple(a.shape), dtype=a.dtype), tree)
    return tree_map(lambda pl, a: dt_empty(tuple(a.shape), dtype=a.dtype,
                                           device_mesh=mesh, placements=pl),
                    shardings, tree)


def _trace_once(cfg: ModelConfig, shape: ShapeSpec, mesh, rules,
                step_cfg: Optional[StepConfig] = None) -> Dict[str, Any]:
    """Trace one step of (cfg, shape) on ``mesh``; this rank's counts.
    With no mesh (and no rules) the step runs on plain fake tensors, as
    on one card."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    with FakeTensorMode(), use_rules(rules):
        in_specs = input_specs(cfg, shape)
        sharded = mesh is not None
        batch = _fake_like(in_specs, sharded and batch_shardings(in_specs, rules), mesh)
        params_abs = lm.abstract_params(cfg)
        if shape.kind == "train":
            opt = pick_optimizer(cfg)
            sc = step_cfg or StepConfig(
                microbatches=ARCH_MICROBATCHES.get(cfg.name, 1),
                remat="full", attention_impl="auto")
            abstract = abstract_train_state(cfg, opt)
            specs = train_state_specs(cfg, opt)
            keys = ("params", "opt_state")
            state = _fake_like({k: abstract[k] for k in keys},
                               sharded and param_shardings(
                                   {k: specs[k] for k in keys}, rules,
                                   {k: abstract[k] for k in keys}), mesh)
            state["step"] = torch.zeros((), dtype=torch.int32)
            step = make_train_step(cfg, opt, sc)
            args = (state, batch)
            run = lambda: step(state, batch)                           # noqa: E731
        else:
            params = _fake_like(params_abs, sharded and param_shardings(
                lm.param_specs(cfg), rules, params_abs), mesh)
            if shape.kind == "prefill":
                args = (params, batch)
                run = lambda: lm.prefill(cfg, params, batch)           # noqa: E731
            else:
                cache_abs = cache_specs(cfg, shape)
                cache = _fake_like(cache_abs, sharded and cache_shardings(cache_abs, rules),
                                   mesh)
                args = (params, batch, cache)
                run = lambda: lm.decode_step(cfg, params, batch["tokens"], cache)  # noqa: E731
        counter = StepCounter(mesh)
        counter.hold(args)
        grad = torch.enable_grad() if shape.kind == "train" else torch.no_grad()
        with grad, counter:
            out = run()
        arg_ids = {id(t.untyped_storage()) for t in tensors_of(args)}
        argument = storage_bytes(args)
        output = storage_bytes(out)
        alias = output - storage_bytes(out, exclude=arg_ids)
        unique = argument - alias + output
        temp = max(counter.peak_bytes - unique, 0)
    return {
        "trace_s": round(time.time() - t0, 1),
        "memory": {"argument_bytes": argument, "output_bytes": output,
                   "temp_bytes": temp, "alias_bytes": alias,
                   "per_device_bytes": unique + temp},
        "flops": float(counter.flops),
        "hlo_bytes": float(counter.bytes),
        "collectives": collective_bytes_by_kind(counter),
        "collectives_by_axis": collective_bytes_by_axis_kind(counter),
        "bytes_by_op": dict(counter.bytes_by_op),
    }


def _extrapolate(c1: Dict[str, Any], c2: Dict[str, Any], L: int) -> Dict[str, Any]:
    """Linear two-point extrapolation: q(L) = q1 + (q2 - q1) * (L - 1).

    Exact for uniform layer stacks: every cost is fixed + L * per_layer.
    """
    def lin(a, b):
        return a + (b - a) * (L - 1)

    out = {"flops": lin(c1["flops"], c2["flops"]),
           "hlo_bytes": lin(c1["hlo_bytes"], c2["hlo_bytes"])}
    kinds = set(c1["collectives"]) | set(c2["collectives"])
    out["collectives"] = {
        k: lin(c1["collectives"].get(k, 0.0), c2["collectives"].get(k, 0.0))
        for k in kinds}
    ba1, ba2 = c1.get("collectives_by_axis"), c2.get("collectives_by_axis")
    if ba1 is not None and ba2 is not None:
        labels = set(ba1) | set(ba2)
        out["collectives_by_axis"] = {
            lab: {k: lin(ba1.get(lab, {}).get(k, 0.0),
                         ba2.get(lab, {}).get(k, 0.0))
                  for k in set(ba1.get(lab, {})) | set(ba2.get(lab, {}))}
            for lab in labels}
    return out


def _extrapolate_memory(m1: Dict[str, int], m2: Dict[str, int], L: int) -> Dict[str, int]:
    return {k: m1[k] + (m2[k] - m1[k]) * (L - 1) for k in m1}


def lower_cell(arch: str, shape_name: str, mesh=None, multi_pod: bool = False,
               rules_overrides: Optional[Dict[str, Any]] = None,
               step_cfg: Optional[StepConfig] = None) -> Dict[str, Any]:
    """Trace one cell; returns its record (JAX's keys, and ``trace_s``,
    ``counter``, ``memory_method``).

    Two traces, at depth 1 and 2, extrapolated to the full depth. Without a
    ``mesh`` a fake process group of the plan's world size is made for
    the call and the mesh comes from the KND path; a given ``mesh`` needs
    the caller's group.
    """
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}

    with contextlib.ExitStack() as stack:
        if mesh is None:
            stack.enter_context(fake_group(512 if multi_pod else 256))
            # the KND path: claim + workload through the control plane
            mesh, _plan = make_planned_mesh(multi_pod=multi_pod, device_type="cpu")
        rules = ShardingRules(mesh=mesh)
        if arch in ARCH_RULES:
            rules = rules.updated(ARCH_RULES[arch])
        if rules_overrides:
            rules = rules.updated(rules_overrides)

        record: Dict[str, Any] = {
            "arch": arch, "shape": shape_name, "kind": shape.kind,
            "mesh": "x".join(str(s) for s in mesh.shape),
            "axes": list(mesh.mesh_dim_names), "devices": int(mesh.size()),
            "params": cfg.param_count(), "active_params": cfg.active_param_count(),
            "counter": "torch-fake",
        }
        if shape.kind == "train":
            record["optimizer"] = pick_optimizer(cfg).name

        c1 = _trace_once(cfg.replace(num_layers=1), shape, mesh, rules, step_cfg)
        c2 = _trace_once(cfg.replace(num_layers=2), shape, mesh, rules, step_cfg)
        record.update(_extrapolate(c1, c2, cfg.num_layers))
        record["memory"] = _extrapolate_memory(c1["memory"], c2["memory"], cfg.num_layers)
        record["trace_s"] = round(c1["trace_s"] + c2["trace_s"], 1)
        record["cost_method"] = record["memory_method"] = "two-point-extrapolation"
    record["status"] = "ok"
    return record


def card_step(cfg: ModelConfig, batch: int, seq: int, hw: HardwareSpec = H100,
              seed: int = 0, repeats: int = 3) -> Dict[str, Any]:
    """The dry run held against a card: one AdamW step of ``cfg`` on
    ``batch`` x ``seq`` tokens (remat full, ``attention_impl="auto"``, no
    mesh) traced on fake tensors, then run on the card under the same
    counter (after one warm-up step, the caller's state held as a
    launcher holds it), then timed (CUDA events, median of ``repeats``)
    and profiled once (the device time of one step). Returns the trace's
    and the card's counts, the ops whose bytes differ most between them,
    the card's peak memory above what was allocated before the state, the
    trace's roofline on ``hw`` and the measured step ms."""
    sc = StepConfig(microbatches=1, remat="full", attention_impl="auto")
    shape = ShapeSpec(f"card_{batch}x{seq}", seq, batch, "train")
    pred = _trace_once(cfg, shape, None, None, sc)
    record = {"arch": cfg.name, "shape": shape.name, "kind": "train", "mesh": "1",
              "axes": [], "devices": 1, "params": cfg.param_count(),
              "active_params": cfg.active_param_count(), "status": "ok", **pred}
    roof = roofline_terms(record, hw=hw)

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    opt = pick_optimizer(cfg)
    state = init_train_state(cfg, opt, seed, torch.device("cuda"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    data = {k: torch.randint(0, cfg.vocab_size, (batch, seq), generator=g, device="cuda",
                             dtype=torch.int32) for k in ("tokens", "labels")}
    step = make_train_step(cfg, opt, sc)
    state, _ = step(state, data)                           # warm-up
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    counter = StepCounter()
    counter.hold((state, data))
    with counter:
        state, metrics = step(state, data)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    loss = float(metrics["loss"])
    ms = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = step(state, data)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, data)
        torch.cuda.synchronize()
    device_us = sum(getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
                    for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    del state, data
    gc.collect()
    torch.cuda.empty_cache()
    step_ms = statistics.median(ms)
    return {"predicted": {"flops": pred["flops"], "bytes": pred["hlo_bytes"],
                          "peak_bytes": pred["memory"]["per_device_bytes"]},
            "card": {"flops": float(counter.flops), "bytes": float(counter.bytes),
                     "bytes_rel": abs(pred["hlo_bytes"] - counter.bytes) / max(counter.bytes, 1),
                     "bytes_by_op_diff": _largest_differences(pred["bytes_by_op"],
                                                              counter.bytes_by_op),
                     "counted_peak_bytes": counter.peak_bytes,
                     "max_memory_allocated_bytes": peak},
            "roofline": {"compute_s": roof.compute_s, "memory_s": roof.memory_s,
                         "step_time_s": roof.step_time_s, "dominant": roof.dominant},
            "step_ms": step_ms, "step_ms_all": ms, "loss": loss,
            "device_ms_per_step": device_us / 1e3,
            "device_share": device_us / 1e3 / step_ms if step_ms else None}


def _largest_differences(a: Dict[str, int], b: Dict[str, int], n: int = 5
                         ) -> Dict[str, list]:
    """The ``n`` ops whose counts differ most between ``a`` and ``b``."""
    ops = sorted(set(a) | set(b), key=lambda k: -abs(a.get(k, 0) - b.get(k, 0)))
    return {k: [a.get(k, 0), b.get(k, 0)] for k in ops[:n] if a.get(k, 0) != b.get(k, 0)}


def run_all(out_dir: str, multi_pod: bool, archs=None, shapes=None) -> int:
    os.makedirs(out_dir, exist_ok=True)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    failures = 0
    with fake_group(512 if multi_pod else 256):
        mesh, _plan = make_planned_mesh(multi_pod=multi_pod, device_type="cpu")
        for arch in (archs or ARCHS):
            for shape_name in (shapes or SHAPES):
                tag = f"{arch}__{shape_name}__{mesh_tag}"
                path = os.path.join(out_dir, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip-cached] {tag}")
                    continue
                print(f"[lower] {tag} ...", flush=True)
                try:
                    rec = lower_cell(arch, shape_name, mesh=mesh)
                except Exception as e:  # noqa: BLE001
                    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                           "status": "error", "error": repr(e),
                           "trace": traceback.format_exc(limit=8)}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    gb = rec["memory"]["per_device_bytes"] / 2**30
                    extra = (f" mem/dev={gb:.2f}GiB flops={rec['flops']:.3g} "
                             f"trace={rec['trace_s']}s")
                print(f"[{status}] {tag}{extra}", flush=True)
    return failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.all:
        archs = [args.arch] if args.arch else None
        shapes = [args.shape] if args.shape else None
        failures = run_all(args.out, args.multi_pod, archs, shapes)
        sys.exit(1 if failures else 0)

    rec = lower_cell(args.arch or "h2o-danube-1.8b",
                     args.shape or "train_4k",
                     multi_pod=args.multi_pod)
    if rec["status"] == "ok":
        r = roofline_terms(rec)
        rec["roofline"] = {"compute_s": r.compute_s, "memory_s": r.memory_s,
                           "collective_s": r.collective_s, "dominant": r.dominant,
                           "step_time_s": r.step_time_s, "mfu_bound": r.mfu_bound(),
                           "hw": r.details["hw"]}
    print(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()

"""Training through the program's ``Trainer``, as ``launch/train.py`` runs it.

Set-up makes the weights from the seed, AdamW on the cosine schedule,
the step (``make_train_step``: microbatches, remat, the launcher's
attention choice) and one ``Trainer`` over the benchmark's frozen data
generator, with the NRI bus and its ``TelemetryDriver`` and no checkpoint
driver. It drives that trainer through its first ``checked_steps`` steps,
one ``fit(1)`` at a time as the window does, and keeps what the
comparison needs: each step's loss, the first gradient's per-leaf norms
as the optimizer got it (from AdamW's first moment after one step), and
the per-leaf norms of the parameters' change over those steps. The same
trainer then runs the window, step after step, for ``--seconds``.

Afterwards the plain reference trains the same weights on the same
batches for the checked steps in float32 and the numbers are compared.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

import torch

from kndbench import check, trace, weights, work
from kndbench.datagen import SyntheticLMData
from kndbench.harness import Cell, log
from kndbench.reference import train as ref_train


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def build(cell: Cell):
    """The trainer over the benchmark's weights and data, and its pieces."""
    from repro_torch.launch.train import attention_impl
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import cosine_schedule
    from repro_torch.train.train_step import StepConfig, make_train_step
    from repro_torch.train.trainer import Trainer

    job, dev = cell.traffic, torch.device(cell.device)
    cfg = ModelConfig(**cell.model)
    abstract = lm.abstract_params(cfg)
    sched, a = job["schedule"], job["adamw"]
    opt = AdamW(cosine_schedule(sched["peak_lr"], sched["warmup_steps"], sched["total_steps"]),
                b1=a["b1"], b2=a["b2"], eps=a["eps"], weight_decay=a["weight_decay"])
    # the launcher's choice; a model without attention has none to make
    # (the launcher's function reads a head dim it does not have)
    impl = "auto" if cfg.family == "ssm" else attention_impl(cfg, dev)
    sc = StepConfig(microbatches=job["microbatches"], remat=job["remat"],
                    attention_impl=impl, clip_norm=job["clip_norm"])
    data = SyntheticLMData(cfg, global_batch=job["global_batch"], seq_len=job["seq_len"],
                           seed=cell.seed)
    params = weights.make(abstract, cell.seed, dev)
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    trainer = Trainer(cfg, opt, data, step_cfg=sc, device=dev, state=state,
                      _step_fn=make_train_step(cfg, opt, sc))
    return trainer, opt, abstract, data


def checked_steps(cell: Cell, trainer, opt, abstract) -> Dict[str, Any]:
    """Drive the trainer through its first steps; the program's numbers."""
    dev = torch.device(cell.device)
    n = cell.traffic["checked_steps"]
    trainer.fit(1)
    b1 = cell.traffic["adamw"]["b1"]
    first_grad = {k: float(torch.linalg.vector_norm(v)) / (1.0 - b1)
                  for k, v in weights.leaves(trainer.state["opt_state"]["m"])}
    for _ in range(n - 1):
        trainer.fit(1)
    start = dict(weights.leaves(weights.make(abstract, cell.seed, dev)))
    change = {k: float(torch.linalg.vector_norm(v.float() - start[k].float()))
              for k, v in weights.leaves(trainer.state["params"])}
    del start
    _sync(dev)
    return {"losses": [h["loss"] for h in trainer.history[:n]],
            "first_grad": first_grad, "change": change}


def reference(cell: Cell, abstract, data, control: bool) -> Dict[str, Any]:
    dev = torch.device(cell.device)
    n = cell.traffic["checked_steps"]
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in data.batch(s).items()}
               for s in range(n)]
    out = {"f32": ref_train.train(cell.model, cell.traffic,
                                  weights.make(abstract, cell.seed, dev), batches)}
    if control:
        out["fp8"] = ref_train.train(cell.model, cell.traffic,
                                     weights.make(abstract, cell.seed, dev), batches, "fp8")
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()} for b in batches]
        out["half_batch"] = ref_train.train(cell.model, cell.traffic,
                                            weights.make(abstract, cell.seed, dev), half)
    return out


def _free(dev) -> None:
    gc.collect()                      # a Trainer and its bus form a cycle
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def run(cell: Cell) -> Dict[str, Any]:
    from repro_torch.models import layers

    job, m, dev = cell.traffic, cell.model, torch.device(cell.device)
    trainer, opt, abstract, data = build(cell)
    spans = trace.Spans(cell.trace)
    calls: Dict[str, List] = {"flash_attention": [], "ssd_chunk": []}
    rec = {"on": False}
    undo = []
    if cell.trace:
        def flash_rec(q, k, v, causal=True, window=0):
            if rec["on"]:
                calls["flash_attention"].append((tuple(q.shape), tuple(k.shape),
                                                 str(q.dtype).split(".")[-1], window, causal))

        def ssd_rec(C, B, x, dt, da):
            if rec["on"]:
                calls["ssd_chunk"].append((tuple(C.shape), tuple(x.shape),
                                           str(x.dtype).split(".")[-1]))
        undo += [trace.wrap(layers, "flash_attention", "flash_attention", flash_rec),
                 trace.wrap(layers, "ssd_chunk", "ssd_chunk", ssd_rec),
                 trace.wrap(opt, "update", "optimizer")]

    prog = checked_steps(cell, trainer, opt, abstract)
    setup_s = time.perf_counter() - cell.t0

    steps = 0

    def step() -> None:
        nonlocal steps
        with spans("step"):
            trainer.fit(1)
        steps += 1

    t_start = time.perf_counter()
    t_end = t_start + cell.seconds
    while time.perf_counter() < t_end and steps < job["trace_skip_steps"]:
        step()
    prof: Dict[str, Any] = {}
    if cell.trace and time.perf_counter() < t_end:
        rec["on"] = True
        with trace.profiled(True, prof), spans("window"):
            for _ in range(job["trace_steps"]):
                step()
            _sync(dev)
        rec["on"] = False
    while time.perf_counter() < t_end:
        step()
    t_stop = time.perf_counter()
    for u in undo:
        u()
    summary = trace.finish(prof)
    window = t_stop - t_start
    tokens = job["global_batch"] * job["seq_len"]
    log(f"[{cell.name}] window {window:.3f}s: {steps} steps, "
        f"losses {[round(h['loss'], 4) for h in trainer.history[-3:]]}")
    metrics = {"train_tokens_per_s": steps * tokens / window, "setup_s": setup_s}
    counters = {"window_s": window, "steps": steps, "tokens": steps * tokens,
                "model_flops": steps * work.train_step_flops(m, job["global_batch"],
                                                              job["seq_len"]),
                "least_s": {name: sum(_least(name, c) for c in cs)
                            for name, cs in calls.items()}}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    losses_finite = all(h["loss"] == h["loss"] for h in trainer.history)
    del trainer
    _free(dev)
    refs = reference(cell, abstract, data, cell.control)
    numbers = check.train_numbers(prog, refs["f32"])
    if not losses_finite:
        numbers["loss_gap"] = float("inf")
    for name in ("fp8", "half_batch"):
        if name in refs:
            ctl = check.train_numbers(refs[name], refs["f32"])
            tag = "control" if name == "fp8" else "fault_half_batch"
            numbers.update({f"{tag}_{k}": v for k, v in ctl.items()})
    if cell.control:
        # a step that returns its state unchanged: the first loss again
        # and again, no gradient in the optimizer's state, no change
        f32 = refs["f32"]
        still = {"losses": [f32["losses"][0]] * len(f32["losses"]),
                 "first_grad": {k: 0.0 for k in f32["first_grad"]},
                 "change": {k: 0.0 for k in f32["change"]}}
        numbers.update({f"fault_unchanged_{k}": v
                        for k, v in check.train_numbers(still, f32).items()})
    return {"metrics": metrics, "counters": counters, "trace": summary,
            "attempted": steps, "failed": 0, "numbers": numbers,
            "memory_peak_bytes": peak}


def _least(name: str, call) -> float:
    if name == "flash_attention":
        q_shape, k_shape, dtype, window, causal = call
        return work.least_time(*work.flash_fwd_work(q_shape, k_shape, dtype, window, causal),
                               dtype)
    C_shape, x_shape, x_dtype = call
    return work.least_time(*work.ssd_chunk_work(C_shape, x_shape, x_dtype), "float32")

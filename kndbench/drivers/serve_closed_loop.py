"""Serving under a closed loop of clients, through the program's router.

The window drives ``Router.step()`` over one ``ServeEngine`` replica, the
path ``launch/serve.py`` builds. ``clients`` requests are in flight at
all times: a client submits its next request when its last one finishes.
Set-up makes the weights, the engine and its KV pool, warms up the two
tick shapes the traffic uses (a ``prefill_chunk``-wide tick and a
one-token tick) and runs the loop until its first ``ramp_requests``
requests have finished, so that the window starts with the slots'
prefills out of step. Then the window runs for ``--seconds``.

The rate counts the work the window's ticks did: the prompt tokens they
fed and the tokens they sampled, over the window's seconds.

Afterwards a sample of the requests finished in the window, drawn from
the seed with the longest among them, is replayed through the plain
reference: the widest gap by which a served (greedy) token's reference
logit lies below the reference's best is the number compared.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List

import numpy as np
import torch

from kndbench import check, trace, weights, work
from kndbench.harness import Cell, log, percentile
from kndbench.reference import model as ref
from kndbench.traffic_gen import Traffic


class TickCounter:
    """Counts, tick by tick, what the engine feeds the model: real rows,
    fed rows (slots x chunk width), prompt rows, sampled tokens and the
    useful model FLOPs."""

    def __init__(self, m: Dict[str, Any], engine):
        self.m = m
        self.engine = engine
        self.on = False
        self.ticks = self.real = self.fed = self.prompt = self.sampled = 0
        self.flops = 0
        self._step = engine._step
        engine._step = self

    def __call__(self, params, tokens, cache, table, pos, adv, **kw):
        if self.on:
            pos_h, adv_h = pos.cpu().numpy(), adv.cpu().numpy()
            self.ticks += 1
            self.real += int(adv_h.sum())
            self.fed += tokens.shape[0] * tokens.shape[1]
            for i, r in enumerate(self.engine.active):
                n = int(adv_h[i])
                if r is None or n == 0:
                    continue
                p, L = int(pos_h[i]), len(r.prompt)
                self.prompt += max(0, min(p + n, L) - p)
                self.sampled += p + n >= L
                self.flops += work.serve_chunk_flops(self.m, p, n, p + n >= L)
        return self._step(params, tokens, cache, table, pos, adv, **kw)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell) -> Dict[str, Any]:
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.router import Router

    mix, m, dev = cell.traffic, cell.model, torch.device(cell.device)
    cfg = ModelConfig(**m)
    abstract = lm.abstract_params(cfg)
    params = weights.make(abstract, cell.seed, dev)
    engine = ServeEngine(cfg, params, batch_slots=mix["slots"], max_len=mix["max_len"],
                         seed=cell.seed % 2 ** 32, prefill_chunk=mix["prefill_chunk"],
                         block_size=mix["block_size"], device=dev)
    router = Router(max_queue_per_replica=mix["max_queue_per_replica"])
    router.add_replica("replica-0", engine)
    counter = TickCounter(m, engine)
    spans = trace.Spans(cell.trace)
    undo = []
    if cell.trace:
        # a span of its own, so that the breakdown's idle gaps inside it are named
        undo.append(trace.wrap(lm, "attention_decode_paged", "attention_decode_paged"))

    # warm-up: one prefill_chunk-wide tick, then one-token ticks
    router.submit([1] * (mix["prefill_chunk"] + 1), 2, 0.0)
    while router.step():
        pass
    _sync(dev)

    stream = iter(Traffic(mix, m["vocab_size"], cell.seed))
    seen = [len(engine.completed), len(engine.failed)]
    temp = float(mix.get("temperature", 0.0))
    submitted: List[Any] = []

    def submit_next() -> None:
        prompt, n_out = next(stream)
        with spans("submit"):
            submitted.append(router.submit(prompt, n_out, temp))

    def tick() -> int:
        """One router tick; each request that finished in it is followed
        by its client's next. Returns how many finished."""
        with spans("tick"):
            router.step()
        new = len(engine.completed) - seen[0] + len(engine.failed) - seen[1]
        seen[0], seen[1] = len(engine.completed), len(engine.failed)
        for _ in range(new):
            submit_next()
        return new

    for _ in range(mix["clients"]):
        submit_next()
    ramp = 0
    while ramp < mix["ramp_requests"]:
        ramp += tick()
    _sync(dev)
    setup_s = time.perf_counter() - cell.t0

    counter.on = True
    t_start = time.perf_counter()
    t_end = t_start + cell.seconds
    while time.perf_counter() < t_end and counter.ticks < mix["trace_skip_ticks"]:
        tick()
    prof: Dict[str, Any] = {}
    if time.perf_counter() < t_end:
        with trace.profiled(cell.trace, prof), spans("window"):
            for _ in range(mix["trace_ticks"] if cell.trace else 0):
                tick()
            _sync(dev)
    while time.perf_counter() < t_end:
        tick()
    t_stop = time.perf_counter()
    counter.on = False
    for u in undo:
        u()
    summary = trace.finish(prof)

    window = t_stop - t_start
    done = [r for r in submitted if r.done and t_start <= r.t_done <= t_stop]
    failed = [r for r in submitted if r.failed and t_start <= r.t_done <= t_stop]
    firsts = [r for r in submitted if r.t_first_token is not None
              and t_start <= r.t_first_token <= t_stop]
    ttft = [1e3 * r.ttft_s for r in firsts] + [math.inf] * len(failed)
    tpot = [1e3 * r.tpot_s for r in done if r.tpot_s is not None]
    log(f"[{cell.name}] window {window:.3f}s: {len(done)} completed, {len(failed)} failed, "
        f"ttft samples {len(ttft)}, tpot samples {len(tpot)}, ticks {counter.ticks}")
    metrics = {
        "serve_tokens_per_s": (counter.prompt + counter.sampled) / window,
        "ttft_p95_ms": percentile(ttft, 95),
        "tpot_p95_ms": percentile(tpot, 95),
        "setup_s": setup_s,
    }
    counters = {"window_s": window, "ticks": counter.ticks, "real_rows": counter.real,
                "fed_rows": counter.fed, "prompt_rows": counter.prompt,
                "sampled": counter.sampled, "model_flops": counter.flops,
                "ttft_samples": len(ttft), "tpot_samples": len(tpot)}
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    # the sample for the comparison: the longest finished request and
    # others drawn from the seed
    rng = np.random.Generator(np.random.PCG64(cell.seed + 7919))
    pool = sorted(done, key=lambda r: r.uid)
    sample = []
    if pool:
        longest = max(pool, key=lambda r: (len(r.prompt) + len(r.generated), r.uid))
        rest = [r for r in pool if r is not longest]
        k = min(len(rest), mix["check_requests"] - 1)
        sample = [longest] + [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]
    served = [(list(r.prompt), list(r.generated)) for r in sample]

    attempted, n_failed = len(done) + len(failed), len(failed)
    del engine, router, params, counter, submitted, done, failed, firsts, pool, sample
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers = compare(m, abstract, cell.seed, dev, served, cell.control)
    return {"metrics": metrics, "counters": counters, "trace": summary,
            "attempted": attempted, "failed": n_failed, "numbers": numbers,
            "memory_peak_bytes": peak, "served": served}


def compare(m: Dict[str, Any], abstract, seed: int, dev, served, control: bool
            ) -> Dict[str, Any]:
    """The reference over each sampled prompt with its served tokens. With
    ``control``, also the fp8 control's gap and that of a fault: each
    request's last served token altered (the next id)."""
    ref.no_tf32()
    w = weights.make(abstract, seed, dev)
    gaps, cgaps, fgaps, n_tokens = [], [], [], 0
    for prompt, gen in served:
        toks = torch.tensor(prompt + gen[:-1], device=dev)
        positions = torch.arange(len(prompt) - 1, len(toks), device=dev)
        logits = ref.logits_at(m, w, toks, positions)
        gaps.append(float(check.logit_gaps(logits, gen).max()))
        n_tokens += len(gen)
        if control:
            low = ref.logits_at(m, w, toks, positions, prec="fp8")
            cgaps.append(float(check.logit_gaps(logits, low.argmax(-1).tolist()).max()))
            altered = gen[:-1] + [(gen[-1] + 1) % m["vocab_size"]]
            fgaps.append(float(check.logit_gaps(logits, altered).max()))
    out = {"logit_gap": max(gaps) if gaps else math.inf, "checked_tokens": n_tokens,
           "checked_requests": len(served)}
    if control:
        out["control_logit_gap"] = max(cgaps) if cgaps else math.nan
        out["fault_altered_token_logit_gap"] = max(fgaps) if fgaps else math.nan
    return out

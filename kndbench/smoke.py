"""Smoke-size cells for the CPU tests: the benchmark's cells with their
widths and depths cut so that a run takes seconds on the CPU. Only the
tests use them; the benchmark's runs take the files as they are."""

from __future__ import annotations

import copy
from typing import Any, Dict

from kndbench import harness

MODELS = {
    "dense": {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
              "head_dim": 16, "d_ff": 128, "vocab_size": 256, "sliding_window": 48},
    "ssm": {"num_layers": 2, "d_model": 64, "vocab_size": 256, "ssm_state": 16,
            "ssm_head_dim": 16, "ssm_chunk": 16},
}
SERVE = {"clients": 4, "slots": 4, "prefill_chunk": 8, "max_len": 96,
         "max_queue_per_replica": 4,
         "prompt_len": {"dist": "lognormal", "median": 30, "mean": 40, "lo": 4, "hi": 80},
         "output_len": {"dist": "lognormal", "median": 4, "mean": 6, "lo": 1, "hi": 16},
         "stratum": 8,
         "ramp_requests": 4, "trace_skip_ticks": 2, "trace_ticks": 3, "check_requests": 3}
TRAIN = {"global_batch": 4, "seq_len": 32, "trace_skip_steps": 1, "trace_steps": 1}


def cell(name: str, seed: int = 1, seconds: float = 1.0, trace: bool = False,
         limits: Dict[str, Any] = None) -> harness.Cell:
    bench = harness.benchmark()
    c = harness.make_cell(bench, name, seed, seconds, trace, 0.0)
    c.device = "cpu"
    c.config = copy.deepcopy(c.config)
    c.config["model"].update(MODELS[c.config["model"]["family"]])
    c.traffic = {**c.traffic, **(SERVE if c.traffic["kind"] != "train" else TRAIN)}
    if limits is not None:
        c.limits = limits
    return c

# Limits for the smoke-size runs of the CPU tests, set from their own
# readings: the sound runs read under half of these, the fp8 control
# and the broken runs above them.
LIMITS = {
    "danube-rag": {"logit_gap": 0.02},
    "mamba2-train-4k": {"grad_gap": 0.015, "median_grad_gap": 0.002, "change_gap": 0.008},
    "danube-train-4k": {"first_loss_gap": 1e-3, "grad_gap": 0.015, "change_gap": 0.008},
}

"""Perf hillclimb: named iterations over the three chosen cells.

The port of the JAX package's ``launch/hillclimb.py``: the same catalog
of iterations (``ITERS``, the JAX package's names and specs), each a
(cell, rules overrides | mesh | step-config change) traced exactly like
the dry run (``launch/dryrun.py``: fake tensors over a fake process
group) and recorded to ``experiments/hillclimb/<iter>.json``; ``main``
prints each one's roofline line on the H100 data sheet's peaks
(``roofline/analysis.py``). It runs the named iterations and searches
nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.hillclimb [ITER ...]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import traceback
from typing import Any, Dict

from ..train.train_step import StepConfig
from .dryrun import fake_group, lower_cell
from .mesh import planned_mesh_for

__all__ = ["ITERS", "run_iter", "main"]

# iteration catalog: name -> spec
ITERS: Dict[str, Dict[str, Any]] = {
    # ---------------- qwen1.5-110b train_4k ----------------
    "qwen-train-baseline": {
        "arch": "qwen1.5-110b", "shape": "train_4k"},
    # H1: sequence-parallel activations conflict with FSDP weight layout
    # (batch:data x seq:model leaves no contractible dim unsharded) -> XLA
    # fully replicates FFN weights per microbatch. qwen's 64 heads divide
    # model=16, so head-TP works: drop SP.
    "qwen-train-headTP": {
        "arch": "qwen1.5-110b", "shape": "train_4k",
        "rules": {"seq": None}},
    # H2: per-microbatch weight gathers repeat 8x; fewer, bigger
    # microbatches trade activation memory for gather traffic.
    "qwen-train-headTP-mu4": {
        "arch": "qwen1.5-110b", "shape": "train_4k",
        "rules": {"seq": None},
        "step": {"microbatches": 4}},
    "qwen-train-headTP-mu2": {
        "arch": "qwen1.5-110b", "shape": "train_4k",
        "rules": {"seq": None},
        "step": {"microbatches": 2}},
    # H2b: cheaper remat policy (dots) cuts recompute HBM traffic
    "qwen-train-headTP-mu4-dots": {
        "arch": "qwen1.5-110b", "shape": "train_4k",
        "rules": {"seq": None},
        "step": {"microbatches": 4, "remat": "dots"}},

    # H1b (applied to the model code): Megatron-SP FFN boundary — seq
    # gathered at FFN entry, hidden dim sharded, re-scatter at exit.
    # (mlp_apply constraint change; this iteration re-measures baseline
    # rules with the fixed constraint.)
    "qwen-train-spffn": {
        "arch": "qwen1.5-110b", "shape": "train_4k"},
    "qwen-train-spffn-mu4": {
        "arch": "qwen1.5-110b", "shape": "train_4k",
        "step": {"microbatches": 4}},
    "qwen-train-spffn-mu2": {
        "arch": "qwen1.5-110b", "shape": "train_4k",
        "step": {"microbatches": 2}},

    # ---------------- grok-1-314b train_4k ----------------
    "grok-train-baseline": {
        "arch": "grok-1-314b", "shape": "train_4k"},
    # H3: 8 experts can't shard over model=16; give grok an expert-aligned
    # mesh (data=16) x (expert=8) x (etp=2) — the KND claim/planner makes
    # arch-appropriate meshes first-class. Expert weights shard
    # (E:expert, D:data, F:etp); dispatch all-to-alls over 'expert'.
    "grok-train-epmesh": {
        "arch": "grok-1-314b", "shape": "train_4k",
        "mesh_shape": (16, 8, 2), "mesh_axes": ("data", "expert", "etp"),
        "rules": {
            "batch": ("data",), "seq": None,
            "experts": "expert", "expert_embed": "data", "expert_ffn": "etp",
            "act_experts": "expert", "moe_cap": None,
            "heads_tp": "etp", "kv_tp": "etp", "ffn_tp": "etp",
            "act_heads": "etp", "act_kv": "etp", "act_ff": "etp",
            "vocab_tp": "etp", "act_vocab": "etp", "embed": "data",
            "seq_kv": None,
        }},
    "grok-train-epmesh-mu4": {
        "arch": "grok-1-314b", "shape": "train_4k",
        "mesh_shape": (16, 8, 2), "mesh_axes": ("data", "expert", "etp"),
        "rules": {
            "batch": ("data",), "seq": None,
            "experts": "expert", "expert_embed": "data", "expert_ffn": "etp",
            "act_experts": "expert", "moe_cap": None,
            "heads_tp": "etp", "kv_tp": "etp", "ffn_tp": "etp",
            "act_heads": "etp", "act_kv": "etp", "act_ff": "etp",
            "vocab_tp": "etp", "act_vocab": "etp", "embed": "data",
            "seq_kv": None,
        },
        "step": {"microbatches": 4}},

    # H3b: epmesh left the expert-buffer capacity dim replicated over
    # data -> every data-rank computed identical expert GEMMs (16x compute
    # waste, measured useful=5%). Shard capacity over data: (e:expert,
    # c:data, f:etp) has zero layout conflicts.
    "grok-train-epmesh-capdata": {
        "arch": "grok-1-314b", "shape": "train_4k",
        "mesh_shape": (16, 8, 2), "mesh_axes": ("data", "expert", "etp"),
        "rules": {
            "batch": ("data",), "seq": None,
            "experts": "expert", "expert_embed": "data", "expert_ffn": "etp",
            "act_experts": "expert", "moe_cap": "data",
            "heads_tp": "etp", "kv_tp": "etp", "ffn_tp": "etp",
            "act_heads": "etp", "act_kv": "etp", "act_ff": "etp",
            "vocab_tp": "etp", "act_vocab": "etp", "embed": "data",
            "seq_kv": None,
        }},
    "grok-train-epmesh-capdata-mu4": {
        "arch": "grok-1-314b", "shape": "train_4k",
        "mesh_shape": (16, 8, 2), "mesh_axes": ("data", "expert", "etp"),
        "rules": {
            "batch": ("data",), "seq": None,
            "experts": "expert", "expert_embed": "data", "expert_ffn": "etp",
            "act_experts": "expert", "moe_cap": "data",
            "heads_tp": "etp", "kv_tp": "etp", "ffn_tp": "etp",
            "act_heads": "etp", "act_kv": "etp", "act_ff": "etp",
            "vocab_tp": "etp", "act_vocab": "etp", "embed": "data",
            "seq_kv": None,
        },
        "step": {"microbatches": 4}},

    # ---------------- arctic-480b decode_32k ----------------
    "arctic-decode-baseline": {
        "arch": "arctic-480b", "shape": "decode_32k"},
    # H4: decode must never gather weights — inference-stationary layout:
    # attention/dense D row-parallel over model, experts fully sharded
    # (E:model, F:data), embeddings vocab-sharded. All comms become tiny
    # activation psums.
    "arctic-decode-stationary": {
        "arch": "arctic-480b", "shape": "decode_32k",
        "rules": {"embed": "model", "expert_embed": None,
                  "expert_ffn": "data", "seq": None}},
    # H4b: also shard the expert dispatch buffers' capacity over data
    # (temps showed 12.9 GiB: replicated dispatch buffers + copies).
    "arctic-decode-stationary-capdata": {
        "arch": "arctic-480b", "shape": "decode_32k",
        "rules": {"embed": "model", "expert_embed": None,
                  "expert_ffn": "data", "seq": None, "moe_cap": "data"}},
}


def run_iter(name: str, out_dir: str = "experiments/hillclimb") -> Dict[str, Any]:
    spec = ITERS[name]
    os.makedirs(out_dir, exist_ok=True)
    step_cfg = None
    if "step" in spec:
        base = dict(microbatches=8, remat="full", attention_impl="auto")
        base.update(spec["step"])
        step_cfg = StepConfig(**base)
    if "mesh_shape" in spec:
        # custom meshes (e.g. grok's expert mesh) also come from the
        # control plane: claim + workload, over a fake group of their size
        with fake_group(math.prod(spec["mesh_shape"])):
            mesh, _plan = planned_mesh_for(spec["mesh_shape"], spec["mesh_axes"],
                                           device_type="cpu")
            rec = lower_cell(spec["arch"], spec["shape"], mesh=mesh,
                             rules_overrides=spec.get("rules"), step_cfg=step_cfg)
    else:
        rec = lower_cell(spec["arch"], spec["shape"],
                         rules_overrides=spec.get("rules"), step_cfg=step_cfg)
    rec["iteration"] = name
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("iters", nargs="*", default=None)
    args = ap.parse_args(argv)
    names = args.iters or list(ITERS)
    for name in names:
        print(f"[hillclimb] {name} ...", flush=True)
        try:
            rec = run_iter(name)
        except Exception as e:  # noqa: BLE001
            print(f"[error] {name}: {e!r}")
            traceback.print_exc(limit=6)
            continue
        if rec.get("status") != "ok":
            print(f"[{rec.get('status')}] {name}: {rec.get('reason', '')}")
            continue
        from ..roofline.analysis import roofline_terms
        r = roofline_terms(rec)
        print(f"[ok] {name}: compute={r.compute_s:.3f}s memory={r.memory_s:.3f}s "
              f"collective={r.collective_s:.3f}s dominant={r.dominant} "
              f"mfu≤{r.mfu_bound() * 100:.1f}% useful={r.useful_ratio * 100:.0f}% "
              f"mem={r.per_device_gib:.1f}GiB", flush=True)


if __name__ == "__main__":
    main()

"""Roofline report generator: dry-run JSONs -> markdown tables.

The port of the JAX package's ``roofline/report.py``; the records of
either package's dry run render alike. The memory table's limit is the
card's memory: ``total_memory`` of device 0 where a card is present,
else the spec's.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, List, Optional

from .analysis import H100, HardwareSpec, RooflineReport, roofline_terms

__all__ = ["load_records", "render_table", "render_memory_table", "card_hbm_gib"]

ALIGNED_DILATION = {"": 1.0}
UNALIGNED_DILATION_16 = {"": 8.03}  # measured: MeshPlanner unaligned, 16x16


def card_hbm_gib(hw: HardwareSpec = H100) -> float:
    """The card's memory in GiB: device 0's where a card is present."""
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory / 2**30
    return hw.hbm_bytes / 2**30


def load_records(dirpath: str, mesh_tag: Optional[str] = None
                 ) -> List[Dict[str, Any]]:
    out = []
    for path in sorted(glob.glob(os.path.join(dirpath, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if mesh_tag and rec.get("mesh") != mesh_tag:
            continue
        out.append(rec)
    return out


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}µs"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def render_table(records: List[Dict[str, Any]],
                 dilation: Optional[Dict[str, float]] = None,
                 title: str = "Roofline (aligned placement)",
                 hw: HardwareSpec = H100) -> str:
    lines = [f"### {title}", "",
             "| arch | shape | compute | memory | collective | dominant | "
             "MFU-bound | useful FLOPs | mem/dev |",
             "|---|---|---|---|---|---|---|---|---|"]
    for rec in records:
        if rec.get("status") == "skipped":
            lines.append(f"| {rec['arch']} | {rec['shape']} | — | — | — | "
                         f"skipped | — | — | — |")
            continue
        if rec.get("status") != "ok":
            lines.append(f"| {rec['arch']} | {rec['shape']} | — | — | — | "
                         f"ERROR | — | — | — |")
            continue
        r: RooflineReport = roofline_terms(rec, dilation=dilation, hw=hw)
        lines.append(
            f"| {r.arch} | {r.shape} | {_fmt_s(r.compute_s)} | "
            f"{_fmt_s(r.memory_s)} | {_fmt_s(r.collective_s)} | "
            f"{r.dominant} | {r.mfu_bound() * 100:.1f}% | "
            f"{r.useful_ratio * 100:.0f}% | {r.per_device_gib:.2f}GiB |")
    return "\n".join(lines)


def render_memory_table(records: List[Dict[str, Any]],
                        hbm_gib: Optional[float] = None) -> str:
    limit = hbm_gib if hbm_gib is not None else card_hbm_gib()
    lines = ["### Dry-run memory (bytes/device)", "",
             f"| arch | shape | mesh | args | temps | total/dev | fits {limit:g}GiB |",
             "|---|---|---|---|---|---|---|"]
    for rec in records:
        if rec.get("status") != "ok":
            continue
        m = rec["memory"]
        tot = m["per_device_bytes"] / 2**30
        args = (m["argument_bytes"] - m["alias_bytes"]) / 2**30
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
            f"{args:.2f} | {m['temp_bytes'] / 2**30:.2f} | {tot:.2f}GiB | "
            f"{'✓' if tot <= limit else '✗ (hillclimb)'} |")
    return "\n".join(lines)

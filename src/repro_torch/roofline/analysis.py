"""Three-term roofline from dry-run records, on an NVIDIA H100.

  compute    = FLOPs / peak                      [dense bf16 matmul rate]
  memory     = bytes / HBM bytes per second
  collective = sum over mesh axes of
                 bytes_axis x dilation / link rate of the axis's class

The same arithmetic as the JAX package's ``roofline/analysis.py``
(``roofline_terms``, ``RooflineReport``, ``_model_flops``); the constants
sit in one :class:`HardwareSpec` passed in, by default :data:`H100`.
A record's counts are per rank already (``roofline/counters.py``), as
XLA's ``cost_analysis()`` of a partitioned module is per device, so they
are used as they are.

Each mesh axis gets a link class: NVLink where the axis's ranks stay
inside one 8-GPU node, else the node's RoCE NIC, the axes packed inner
first (the last axis of the mesh is the innermost, as ``planned_mesh_for``
packs them); the ``pod`` axis always crosses nodes. The NVLink rate is
doubled for a bidirectional ring, as the JAX package doubles its ICI
links; the NIC's is not, as it does not double its DCN.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) per train step; the
ratio MODEL_FLOPS / (FLOPs x ranks) exposes remat and dispatch waste.

The rates of :data:`H100` are the NVIDIA H100 SXM5 data sheet's peaks
(dense bf16 989.4 TFLOP/s, HBM3 3.35 TB/s, at its 700 W), so each term
is a lower bound on the time the card takes for the counted work. The
memory term holds only while every op's operands come from HBM: L2 (50
MB) can serve a small op's operands faster. Measured on an NVIDIA H100
80GB HBM3 at a power limit of 700.00 W (``chip_smoke.py``'s ``[dryrun
card]`` phase, ``roofline/measure.py``; torch 2.11.0+cu128, CUDA 12.8),
the card reaches less: an 8192^3 bf16 ``torch.matmul`` 766.04 TFLOP/s
and a device-to-device copy of 2 GiB 3.0262 TB/s, read + written. Its
memory, ``total_memory``, is 85 017 493 504 bytes (``HBM_BYTES``, read
on that card). The phase prints danube's ``train_4k`` roofline at the
rates it measures beside the bound.

One card cannot measure links: NVLink 4 (450 GB/s per direction on H100
SXM) and one 400 Gb/s RoCE NIC per GPU (the CX-7 of
``topology/gcp.py``) are data-sheet values, not measured.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

__all__ = ["HardwareSpec", "H100", "roofline_terms", "RooflineReport",
           "link_class"]


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float          # dense matmul FLOP/s in the compute dtype
    hbm_bps: float             # HBM bytes/s
    hbm_bytes: float           # device memory, bytes
    intra_bps: float           # an axis inside one node (ring rate)
    inter_bps: float           # an axis across nodes, per rank
    node_size: int             # ranks per node


# NVIDIA H100 SXM5 data sheet (700 W): dense bf16 matmul, HBM3
PEAK_BF16_FLOPS = 989.4e12
HBM_BPS = 3.35e12
# NVIDIA H100 80GB HBM3 (700.00 W): total_memory, read in [dryrun card]
HBM_BYTES = 85017493504
# data sheet, not measured (one card has no link to measure)
NVLINK_BPS = 450e9 * 2         # NVLink 4 per direction, bidirectional ring
ROCE_BPS = 400e9 / 8           # one 400 Gb/s CX-7 RoCE NIC per GPU
NODE_GPUS = 8

H100 = HardwareSpec("NVIDIA H100 SXM5 data sheet (700 W)", PEAK_BF16_FLOPS,
                    HBM_BPS, HBM_BYTES, NVLINK_BPS, ROCE_BPS, NODE_GPUS)


def link_class(label: str, axis_sizes: Dict[str, int], hw: HardwareSpec) -> str:
    """``"intra"`` where the ranks of a record's ``collectives_by_axis``
    label stay inside one node, else ``"inter"``: the mesh's axes packed
    inner first; ``pod`` always inter; ``span<n>`` intra when n ranks fit
    a node."""
    if label.startswith("pod"):
        return "inter"
    m = re.fullmatch(r"span(\d+)", label)
    if m:
        return "intra" if int(m.group(1)) <= hw.node_size else "inter"
    inner = 1
    for name in reversed(list(axis_sizes)):
        if name == "pod":
            continue
        inner *= axis_sizes[name]
        if name == label:
            return "intra" if inner <= hw.node_size else "inter"
    return "intra" if hw.node_size >= 1 << 30 else "inter"


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_total: float
    useful_ratio: float
    per_device_gib: float
    details: Dict[str, Any] = field(default_factory=dict)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap lower bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def no_overlap_step_s(self) -> float:
        return self.compute_s + self.memory_s + self.collective_s

    def mfu_bound(self) -> float:
        """Model-FLOPs utilization upper bound at the roofline step time."""
        if self.step_time_s <= 0:
            return 0.0
        chips = self.details.get("devices", 1)
        peak = self.details.get("peak_flops", H100.peak_flops)
        return self.model_flops / (self.step_time_s * chips * peak)


def _model_flops(record: Dict[str, Any], tokens: int) -> float:
    n = record.get("active_params") or record.get("params", 0)
    if record.get("kind") == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens  # inference fwd only


def _axis_sizes(record: Dict[str, Any]) -> Dict[str, int]:
    sizes = [int(s) for s in str(record.get("mesh", "")).split("x") if s]
    return dict(zip(record.get("axes", []), sizes))


def roofline_terms(record: Dict[str, Any],
                   dilation: Optional[Dict[str, float]] = None,
                   axis_sizes: Optional[Dict[str, int]] = None,
                   hw: HardwareSpec = H100) -> RooflineReport:
    """record: one dry-run JSON cell (status == ok)."""
    assert record["status"] == "ok", record
    devices = record["devices"]
    compute_s = record["flops"] / hw.peak_flops
    memory_s = record["hlo_bytes"] / hw.hbm_bps

    # collective: per-kind bytes are per-rank payloads of each op
    coll = record.get("collectives", {})
    dil = max((dilation or {"": 1.0}).values())
    sizes = axis_sizes or _axis_sizes(record)
    coll_intra = 0.0
    coll_inter = 0.0
    by_axis = record.get("collectives_by_axis")
    if by_axis:
        for label, kinds in by_axis.items():
            total = sum(kinds.values())
            if link_class(label, sizes, hw) == "inter":
                coll_inter += total
            else:
                coll_intra += total
    else:
        coll_intra = sum(coll.values())
    # the placement's dilation stretches the rings inside a node's links,
    # as the JAX package's stretches its ICI rings
    collective_s = coll_intra * dil / hw.intra_bps + coll_inter / hw.inter_bps

    if record.get("kind") == "train":
        shape_tokens = {"train_4k": 4096 * 256}.get(record["shape"], 0)
    elif record.get("kind") == "prefill":
        shape_tokens = {"prefill_32k": 32768 * 32}.get(record["shape"], 0)
    else:
        bsz = {"decode_32k": 128, "long_500k": 1}.get(record["shape"], 1)
        shape_tokens = bsz  # one token per sequence
    model_flops = _model_flops(record, shape_tokens)
    hlo_total = record["flops"] * devices
    useful = model_flops / hlo_total if hlo_total else 0.0

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)  # type: ignore[arg-type]
    return RooflineReport(
        arch=record["arch"], shape=record["shape"], mesh=record["mesh"],
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        hlo_flops_total=hlo_total, useful_ratio=useful,
        per_device_gib=record["memory"]["per_device_bytes"] / 2**30,
        details={"devices": devices, "collectives": coll,
                 "dilation": dilation or {}, "peak_flops": hw.peak_flops,
                 "hw": hw.name},
    )

"""The roofline's rates read on one card.

``measure_constants`` reads a card's dense bf16 matmul rate and its HBM
bytes/s, to be held against the data sheet (:data:`DATASHEET`, the
rates of ``analysis.H100``): a reading above it is a measurement fault.
``chip_smoke.py``'s ``[dryrun card]`` phase and the card tests call it.
"""

from __future__ import annotations

import statistics
from typing import Dict

import torch

from .analysis import H100, HardwareSpec

__all__ = ["DATASHEET", "measure_constants", "spec_from"]

# NVIDIA H100 SXM5 data sheet: dense (no sparsity) bf16, HBM3 bandwidth
DATASHEET = {"bf16_flops": H100.peak_flops, "hbm_bps": H100.hbm_bps}


def _event_ms(fn, reps: int, inner: int) -> float:
    """Median over ``reps`` CUDA-event windows of ``inner`` calls, ms per call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / inner)
    return statistics.median(out)


def measure_constants(n: int = 8192, copy_gib: float = 2.0, reps: int = 5
                      ) -> Dict[str, float]:
    """The card's dense bf16 matmul FLOP/s (an n x n x n ``torch.matmul``,
    median of ``reps`` windows), its HBM bytes/s (a device-to-device copy
    of ``copy_gib`` GiB: read + written) and its memory (``total_memory``)."""
    dev = torch.device("cuda")
    a = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=dev, dtype=torch.bfloat16)
    out = {"bf16_flops": 2.0 * n ** 3 / (_event_ms(lambda: torch.matmul(a, b), reps, 10) / 1e3)}
    del a, b
    x = torch.empty(int(copy_gib * 2**30) // 4, device=dev, dtype=torch.float32)
    y = torch.empty_like(x)
    ms = _event_ms(lambda: y.copy_(x), reps, 5)
    out["hbm_bps"] = 2.0 * x.numel() * 4 / (ms / 1e3)
    out["hbm_bytes"] = float(torch.cuda.get_device_properties(0).total_memory)
    del x, y
    torch.cuda.empty_cache()
    return out


def spec_from(measured: Dict[str, float], name: str) -> HardwareSpec:
    """The H100 spec at the measured bf16 rate, HBM rate and memory (the
    links stay the data sheet's): what the card reaches, not a bound."""
    return HardwareSpec(name, measured["bf16_flops"], measured["hbm_bps"],
                        measured["hbm_bytes"], H100.intra_bps, H100.inter_bps,
                        H100.node_size)

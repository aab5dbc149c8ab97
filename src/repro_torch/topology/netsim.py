"""Analytic TPU ICI ring-collective model (the part the scheduler needs).

The port's copy of ``ring_collective_time`` from the JAX package's
``topology/netsim.py``: ring collectives over a mesh axis with
*placement hop-dilation* — a logical ring whose neighbors sit d hops
apart on the torus serializes d link traversals per step, so time scales
by mean(d) (bandwidth) and alpha by max(d) (latency). The NCCL/RoCE
lottery model of that module is not ported yet.

Bandwidths GB/s; sizes bytes; times seconds.
"""

from __future__ import annotations

from .tpu import ICI_BW, ICI_LAT

__all__ = ["ring_collective_time"]


def ring_collective_time(collective: str, size: float, axis_size: int,
                         link_bw_gbs: float = ICI_BW,
                         dilation_mean: float = 1.0,
                         dilation_max: int = 1,
                         alpha: float = ICI_LAT,
                         bidirectional: bool = True) -> float:
    """Time for one collective over a mesh axis of ``axis_size`` ranks.

    ``size`` is the FULL logical payload (e.g. the gathered array bytes
    for all_gather, the reduced array bytes for all_reduce).
    Bidirectional ICI rings stream both directions -> 2x link bandwidth.
    Dilated placements multiply the beta term by mean hop distance (link
    serialization) and the alpha term by max hop distance.
    """
    n = axis_size
    if n <= 1:
        return 0.0
    bw = link_bw_gbs * 1e9 * (2.0 if bidirectional else 1.0)
    shard = size / n
    if collective in ("all_gather", "reduce_scatter"):
        steps = n - 1
        payload = steps * shard
    elif collective == "all_reduce":
        steps = 2 * (n - 1)
        payload = steps * shard
    elif collective == "all_to_all":
        # ring all-to-all: each rank forwards (n-1)/2 shards on average
        steps = n - 1
        payload = size * (n - 1) / (2 * n)
    elif collective == "collective_permute":
        steps = 1
        payload = size
    else:
        raise ValueError(f"unknown collective {collective!r}")
    return steps * alpha * dilation_max + payload * dilation_mean / bw

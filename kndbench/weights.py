"""Model weights made by the benchmark from ``--seed``, on the device.

The shapes and dtypes come from the program's abstract parameter tree
(``lm.abstract_params(cfg)``: meta tensors); the values are the
benchmark's own: one normal draw per dtype from a ``torch.Generator`` on
the device, cut into the leaves and scaled per leaf, plus the constant
leaves. The same seed on the same device gives the same weights, so the
plain reference rebuilds them after the window instead of keeping a copy.

Per leaf, by its name: RMSNorm scales and the SSD's skip ``d_skip`` are
ones; biases (``dt_bias``, ``conv_b``, ``bq``/``bk``/``bv``) zeros; the
SSD's ``a_log`` is log(linspace(1, 16, H)) in every layer, Mamba-2's decay
rates; the conv is N(0, 0.1); the embedding and head N(0, 0.02); every
other matrix N(0, 2 / fan_in), the fan-in being its input width (``wo``:
heads x head dim).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

Tree = Dict[str, Any]

_ONES = ("scale", "d_skip")
_ZEROS = ("dt_bias", "conv_b", "bq", "bk", "bv")
_SMALL = {"embed": 0.02, "head": 0.02, "conv_w": 0.1}


def leaves(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) in the tree's key order, paths joined by '/'."""
    out = []
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.extend(leaves(v, p))
        else:
            out.append((p, v))
    return out


def _unflatten(abstract: Tree, values: Dict[str, torch.Tensor], prefix: str = "") -> Tree:
    out = {}
    for k, v in abstract.items():
        p = f"{prefix}/{k}" if prefix else k
        out[k] = _unflatten(v, values, p) if isinstance(v, dict) else values[p]
    return out


def _std(path: str, shape: Tuple[int, ...]) -> float:
    name = path.rsplit("/", 1)[-1]
    if name in _SMALL:
        return _SMALL[name]
    u = shape[1:] if path.startswith("layers/") else shape     # one layer's shape
    fan_in = u[0] * u[1] if name == "wo" else u[0]
    return math.sqrt(2.0 / max(fan_in, 1))


def make(abstract: Tree, seed: int, device) -> Tree:
    """The parameter tree with the benchmark's values for ``seed``."""
    device = torch.device(device)
    named = leaves(abstract)
    values: Dict[str, torch.Tensor] = {}
    drawn: Dict[torch.dtype, List[Tuple[str, Any]]] = {}
    for path, a in named:
        name = path.rsplit("/", 1)[-1]
        shape = tuple(a.shape)
        if name in _ONES:
            values[path] = torch.ones(shape, dtype=a.dtype, device=device)
        elif name in _ZEROS:
            values[path] = torch.zeros(shape, dtype=a.dtype, device=device)
        elif name == "a_log":
            H = shape[-1]
            row = torch.log(torch.linspace(1.0, 16.0, H, device=device))
            values[path] = row.expand(shape).to(a.dtype).contiguous()
        else:
            drawn.setdefault(a.dtype, []).append((path, a))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    for dtype, group in drawn.items():
        total = sum(a.numel() for _, a in group)
        buf = torch.empty(total, dtype=dtype, device=device).normal_(generator=gen)
        off = 0
        for path, a in group:
            n = a.numel()
            values[path] = buf[off:off + n].view(tuple(a.shape)).mul_(_std(path, tuple(a.shape)))
            off += n
    return _unflatten(abstract, values)

"""The comparisons that decide ``correct``: the program's outputs against
the plain reference's, each number beside its limit.

Serving: the widest gap, over every served token of the sampled
requests, by which the reference's logit of that token lies below the
reference's best logit at its position (greedy tokens only).

Training: each checked step's loss (``loss_gap``, the worst step; or
``first_loss_gap``, the first step's alone, where a cell's later steps
read the noise of the first update), the norm of the first step's
gradient as the optimizer got it, and the norm of the parameters' change
over the checked steps. Norms are compared leaf by leaf and the worst
leaf is kept: the gap between the program's norm and the reference's, over
the reference's norm of that leaf or of the median leaf, whichever is
larger (``*_gap``), or the median of those leaf gaps (``median_*_gap``)
where a cell's worst leaf reads the noise of its small leaves. Leaves
whose first reference gradient is under a thousandth of the median
leaf's are left out of the change (they move by round-off).
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

import torch

EXCLUDE_BELOW = 1e-3


def logit_gaps(ref_logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """(n,) gaps: best reference logit minus the served token's."""
    ref_logits = ref_logits.float()
    t = torch.as_tensor(list(tokens), device=ref_logits.device).long()
    return ref_logits.max(dim=-1).values - ref_logits.gather(1, t[:, None])[:, 0]


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys: List[str]
          ) -> Dict[str, float]:
    """Each leaf's gap of norms over the reference's norm of that leaf or
    of the median leaf, whichever is larger."""
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            if math.isfinite(prog[k]) else math.inf for k in keys}


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers compared for a training cell, and the worst leaves."""
    losses = [abs(a - b) / abs(b) if math.isfinite(a) else math.inf
              for a, b in zip(prog["losses"], ref["losses"])]
    keys = sorted(ref["first_grad"])
    grads = _gaps(prog["first_grad"], ref["first_grad"], keys)
    med = statistics.median(ref["first_grad"][k] for k in keys)
    moved = [k for k in keys if ref["first_grad"][k] >= EXCLUDE_BELOW * med]
    changes = _gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": max(losses), "first_loss_gap": losses[0], "loss_gaps": losses,
            "grad_gap": max(grads.values()), "change_gap": max(changes.values()),
            "median_grad_gap": statistics.median(grads.values()),
            "median_change_gap": statistics.median(changes.values()),
            "grad_leaf": max(grads, key=grads.get), "change_leaf": max(changes, key=changes.get),
            "excluded": [k for k in keys if k not in moved]}


def judge(numbers: Dict[str, float], limits: Dict[str, Optional[float]]
          ) -> Tuple[bool, Dict[str, Dict[str, Optional[float]]]]:
    """Each limited number beside its limit; correct when every one is
    finite and at or under its limit (a missing limit fails)."""
    table, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        table[name] = {"value": v, "limit": limit}
        if v is None or limit is None or not math.isfinite(v) or v > limit:
            ok = False
    return ok, table

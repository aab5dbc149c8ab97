"""The seed fixed-width batcher, preserved verbatim as a reference arm.

The port of the JAX package's ``serve/legacy.py``: the PR-0
``ServeEngine`` (4-slot fixed-width, single scalar cache clock,
token-by-token prefill catch-up) on :func:`repro_torch.models.lm.
decode_step` over the dense cache, written in place where the JAX
engine donates it. It is kept — bugs and all — for two reasons:

* **benchmark baseline**: the "seed fixed-width" arm against the
  continuous-batching engine;
* **regression oracle**: ``tests/test_torch_legacy.py`` demonstrates
  its known correctness bugs *against this implementation*, proving the
  regression tests of the port's engine actually detect them.

Known bugs (fixed in :mod:`repro_torch.serve.engine` / :mod:`.kvcache`,
NOT here — this file is the bug museum, do not repair it; the port
keeps all four on purpose):

1. **KV contamination on slot recycle.** ``step()`` frees a slot
   without resetting its cache rows or the shared clock; the next
   occupant starts at the old clock with the predecessor's keys/values
   still visible under the ``idx <= pos`` mask, so its logits attend to
   another request's prompt.
2. **Unbounded scalar clock.** Nothing checks ``pos < max_len``; a long
   session silently scatters past the cache (writes are dropped, as
   ``attention_decode`` drops them / a sliding window wraps its ring)
   and keeps "serving" wrong tokens.
3. **Empty prompts crash late.** ``submit([])`` is accepted and only
   explodes (or feeds garbage) when ``_next_tokens`` hits
   ``prompt[-1]``.
4. **Silent loss at the step cap.** ``run(max_steps=...)`` returns only
   ``completed`` — still-pending/active requests vanish from the
   caller's view.
"""

from __future__ import annotations

import functools
import itertools
from dataclasses import dataclass, field
from typing import Any, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models import lm
from ..models.config import ModelConfig

__all__ = ["LegacyServeEngine", "LegacyRequest"]


@dataclass
class LegacyRequest:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    uid: int = 0
    # filled by the engine
    generated: List[int] = field(default_factory=list)
    done: bool = False


class LegacyServeEngine:
    """``params`` must already lie on ``device`` (``None`` = the GPU;
    pass ``"cpu"`` for the CPU)."""

    def __init__(self, cfg: ModelConfig, params: Any, batch_slots: int = 4,
                 max_len: int = 256, seed: int = 0, *,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots = batch_slots
        self.max_len = max_len
        self.rng = np.random.RandomState(seed)
        self._uid = itertools.count()

        self._decode = functools.partial(lm.decode_step, cfg)
        self.cache = lm.init_cache(cfg, batch_slots, max_len, self.device)
        # the seed's single scalar clock: all slots share one position,
        # joining requests prefill token-by-token to catch up
        self.cache["pos"] = torch.zeros((), dtype=torch.int32, device=self.device)
        self.active: List[Optional[LegacyRequest]] = [None] * batch_slots
        self.pending: List[LegacyRequest] = []
        self.completed: List[LegacyRequest] = []
        self._slot_fill: List[int] = [0] * batch_slots  # prompt tokens pending

    # -- API -------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               temperature: float = 0.0) -> LegacyRequest:
        r = LegacyRequest(list(prompt), max_new_tokens, temperature,
                          uid=next(self._uid))
        self.pending.append(r)
        return r

    def _admit(self) -> None:
        for i in range(self.slots):
            if self.active[i] is None and self.pending:
                r = self.pending.pop(0)
                self.active[i] = r
                self._slot_fill[i] = 0

    def _next_tokens(self) -> np.ndarray:
        """Token each slot feeds this step (prompt feed or last sample)."""
        toks = np.zeros((self.slots,), np.int32)
        for i, r in enumerate(self.active):
            if r is None:
                continue
            fed = self._slot_fill[i]
            if fed < len(r.prompt):
                toks[i] = r.prompt[fed]
            elif r.generated:
                toks[i] = r.generated[-1]
            else:
                toks[i] = r.prompt[-1]
        return toks

    def _sample(self, logits: np.ndarray, r: LegacyRequest) -> int:
        if r.temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / r.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    def step(self) -> None:
        """One engine tick: feed one token per active slot."""
        self._admit()
        toks = self._next_tokens()
        arr = torch.from_numpy(toks).to(self.device)[:, None]
        if self.cfg.frontend == "audio":
            arr = arr[..., None].expand(-1, -1, self.cfg.num_codebooks)
        logits, self.cache = self._decode(self.params, arr, self.cache)
        logits_np = logits[:, 0].float().cpu().numpy()
        if self.cfg.frontend == "audio":
            logits_np = logits_np[:, 0]  # sample codebook 0 for the demo
        for i, r in enumerate(self.active):
            if r is None:
                continue
            self._slot_fill[i] += 1
            if self._slot_fill[i] < len(r.prompt):
                continue  # still prefilling this slot
            nxt = self._sample(logits_np[i], r)
            r.generated.append(nxt)
            if len(r.generated) >= r.max_new_tokens:
                r.done = True
                self.completed.append(r)
                self.active[i] = None

    def run(self, max_steps: int = 512) -> List[LegacyRequest]:
        steps = 0
        while (self.pending or any(self.active)) and steps < max_steps:
            self.step()
            steps += 1
        return self.completed

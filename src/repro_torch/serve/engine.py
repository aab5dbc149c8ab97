"""Continuous-batching serve engine over a paged KV cache (PyTorch).

The port of the JAX package's ``ServeEngine``, with the same surface:
requests join slots independently, prefill in chunks, decode one token
per tick and recycle through :class:`~repro_torch.serve.kvcache.
KVCacheManager`, which zero-epochs recycled blocks so no request can
attend to a predecessor's K/V. One :func:`repro_torch.models.lm.
decode_chunk` call serves mixed phases per tick: a slot prefilling a
16-token prompt chunk rides next to a slot decoding its 40th token.

Request lifecycle errors are per-request and typed: an invalid submit
or a cache-bounds breach fails that request with a :class:`ServeError`
subclass, never the engine, and ``run(max_steps=...)`` fails whatever
is still unfinished at the cap with :class:`DeadlineExceededError`.
For the audio family each fed token goes to every codebook stream and
codebook 0's logits are sampled, as in the JAX engine. A prompt with a
token id outside ``[0, vocab)`` (per codebook for audio) fails at
submit with :class:`InvalidTokenError`. This departs from the JAX engine on
purpose: there such a request completes, its tokens drawn from the NaN
logits that ``jnp.take`` leaves for the id; here the id would fail the
embedding lookup of the whole tick (a device-side assert on CUDA).

Counts are plain integers (``stats()``); sampling uses
``np.random.RandomState(seed)`` as the JAX engine does, so temperature
sampling draws the same tokens from equal logits.
"""

from __future__ import annotations

import functools
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..api.chaos import sync_point
from ..device import resolve_device
from ..models import lm
from ..models.config import ModelConfig
from .kvcache import KVCacheManager

__all__ = ["ServeEngine", "Request", "ServeError", "EmptyPromptError",
           "InvalidTokenError", "CacheOverflowError", "DeadlineExceededError",
           "STATUS_QUEUED", "STATUS_PREFILL", "STATUS_DECODE",
           "STATUS_DONE", "STATUS_FAILED"]


class ServeError(RuntimeError):
    """Base class for per-request serving failures."""


class EmptyPromptError(ServeError):
    """submit() got an empty prompt."""


class InvalidTokenError(ServeError):
    """submit() got a prompt with a token id outside [0, vocab)."""


class CacheOverflowError(ServeError):
    """The request's token budget does not fit the slot's KV capacity."""


class DeadlineExceededError(ServeError):
    """run(max_steps=...) hit its cap with this request unfinished."""


STATUS_QUEUED = "queued"
STATUS_PREFILL = "prefill"
STATUS_DECODE = "decode"
STATUS_DONE = "done"
STATUS_FAILED = "failed"


@dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    uid: int = 0
    # engine-written
    generated: List[int] = field(default_factory=list)
    state: str = STATUS_QUEUED
    error: Optional[ServeError] = None
    t_submit: float = 0.0
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def done(self) -> bool:
        return self.state == STATUS_DONE

    @property
    def failed(self) -> bool:
        return self.state == STATUS_FAILED

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        """Time to first token."""
        return (None if self.t_first_token is None
                else self.t_first_token - self.t_submit)

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token over the decode phase."""
        if (self.t_done is None or self.t_first_token is None
                or len(self.generated) < 2):
            return None
        return (self.t_done - self.t_first_token) / (len(self.generated) - 1)


class ServeEngine:
    """Continuous batching: admit/prefill/decode/recycle per slot.

    ``prefill_chunk`` bounds how many prompt tokens a slot feeds per
    tick. ``num_blocks`` overrides the KV pool size (default: exactly
    ``slots`` worth); admission reserves a request's whole budget up
    front, so the pool is the real backpressure surface. ``params``
    must already lie on ``device`` (``None`` = the GPU).
    """

    def __init__(self, cfg: ModelConfig, params: Any, batch_slots: int = 4,
                 max_len: int = 256, seed: int = 0, *,
                 prefill_chunk: int = 16, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 clock=time.perf_counter, name: Optional[str] = None,
                 device: Union[str, torch.device, None] = None):
        self.cfg = cfg
        self.params = params
        self.device = resolve_device(device)
        self.slots = batch_slots
        self.max_len = max_len
        self.prefill_chunk = max(1, prefill_chunk)
        self.rng = np.random.RandomState(seed)
        self.clock = clock
        self.name = name
        self._uid = itertools.count()
        self.kv = KVCacheManager(cfg, batch_slots, max_len,
                                 block_size=block_size,
                                 num_blocks=num_blocks, device=self.device)
        self._step = functools.partial(lm.decode_chunk, cfg)
        self.active: List[Optional[Request]] = [None] * batch_slots
        self._fed: List[int] = [0] * batch_slots   # prompt tokens fed so far
        self.pending: List[Request] = []
        self.completed: List[Request] = []
        self.failed: List[Request] = []
        self.steps = 0
        self.admitted = 0
        # (completed, failed) counts already returned by run()
        self._run_mark = [0, 0]

    # -- submission --------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               temperature: float = 0.0) -> Request:
        """Queue a request. Invalid requests come back already failed
        with a typed ``error``; ``run()`` reports them with the rest."""
        r = Request(list(prompt), max_new_tokens, temperature,
                    uid=next(self._uid))
        r.t_submit = self.clock()
        if not r.prompt:
            return self._fail(r, EmptyPromptError("empty prompt"))
        lo, hi = min(r.prompt), max(r.prompt)
        if lo < 0 or hi >= self.cfg.vocab_size:
            bad = lo if lo < 0 else hi
            return self._fail(r, InvalidTokenError(
                f"token id {bad} outside [0, {self.cfg.vocab_size})"))
        budget = len(r.prompt) + max_new_tokens
        if budget > self.max_len:
            return self._fail(r, CacheOverflowError(
                f"prompt ({len(r.prompt)}) + max_new_tokens "
                f"({max_new_tokens}) = {budget} exceeds max_len "
                f"{self.max_len}"))
        if max_new_tokens < 1:
            return self._fail(r, ServeError("max_new_tokens must be >= 1"))
        self.pending.append(r)
        return r

    def _fail(self, r: Request, err: ServeError,
              slot: Optional[int] = None) -> Request:
        r.state = STATUS_FAILED
        r.error = err
        r.t_done = self.clock()
        self.failed.append(r)
        if slot is not None:
            self.kv.release(slot)
            self.active[slot] = None
        return r

    # -- scheduling --------------------------------------------------------
    def _admit(self) -> None:
        """FIFO admission under strict block reservation: the head of
        the queue is admitted only when a slot AND its whole budget's
        blocks are free."""
        for i in range(self.slots):
            if not self.pending:
                return
            if self.active[i] is not None:
                continue
            head = self.pending[0]
            budget = len(head.prompt) + head.max_new_tokens
            if not self.kv.can_reserve(budget):
                return        # backpressure: pool drained, keep FIFO order
            self.pending.pop(0)
            self.kv.reserve(i, budget)
            self.active[i] = head
            self._fed[i] = 0
            head.state = STATUS_PREFILL
            self.admitted += 1
            sync_point("serve.admit", slot=i, uid=head.uid)

    def has_work(self) -> bool:
        return bool(self.pending) or any(r is not None for r in self.active)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- one tick ----------------------------------------------------------
    def step(self) -> bool:
        """One engine tick; returns False when there was nothing to do."""
        sync_point("serve.step", step=self.steps)
        self._admit()
        slots_live = [i for i, r in enumerate(self.active) if r is not None]
        if not slots_live:
            return False
        self.steps += 1

        adv = np.zeros((self.slots,), np.int32)
        for i in slots_live:
            r = self.active[i]
            remaining = len(r.prompt) - self._fed[i]
            want = min(remaining, self.prefill_chunk) if remaining > 0 else 1
            cap = self.kv.capacity(i)
            if int(self.kv.pos[i]) + want > min(cap, self.max_len):
                # strict reservation makes this unreachable through
                # submit(); kept as the typed bounds gate
                self._fail(r, CacheOverflowError(
                    f"slot {i} clock {int(self.kv.pos[i])}+{want} past "
                    f"capacity {cap}"), slot=i)
                continue
            adv[i] = want
        slots_live = [i for i in slots_live if adv[i] > 0]
        if not slots_live:
            return False

        C = 1 if int(adv.max()) <= 1 else self.prefill_chunk
        feed = np.zeros((self.slots, C), np.int32)
        for i in slots_live:
            r = self.active[i]
            n = int(adv[i])
            fed = self._fed[i]
            if fed < len(r.prompt):
                feed[i, :n] = r.prompt[fed:fed + n]
            else:
                feed[i, 0] = r.generated[-1]

        tokens = self._tensor(feed)
        if self.cfg.frontend == "audio":
            # every codebook stream gets the fed token: a view, no copy
            tokens = tokens[..., None].expand(-1, -1, self.cfg.num_codebooks)

        zb = self.kv.take_zero_blocks()
        rs = self.kv.take_reset_slots()
        logits, self.kv.cache = self._step(
            self.params, tokens, self.kv.cache,
            self._tensor(self.kv.table), self._tensor(self.kv.pos),
            self._tensor(adv),
            zero_blocks=None if zb is None else self._tensor(zb),
            reset_slots=None if rs is None else self._tensor(rs))
        if self.cfg.frontend == "audio":
            logits = logits[:, :, 0]         # sample codebook 0
        # only each slot's last real row is sampled: copy (B, V), not (B, C, V)
        last = torch.from_numpy(np.maximum(adv - 1, 0).astype(np.int64))
        rows = logits[torch.arange(self.slots, device=logits.device),
                      last.to(logits.device)]
        logits_np = rows.float().cpu().numpy()

        now = self.clock()
        for i in slots_live:
            r = self.active[i]
            n = int(adv[i])
            self.kv.advance(i, n)
            if self._fed[i] < len(r.prompt):
                self._fed[i] += n
                if self._fed[i] < len(r.prompt):
                    continue                 # more prompt chunks to go
            nxt = self._sample(logits_np[i], r)
            if r.t_first_token is None:
                r.t_first_token = now
                r.state = STATUS_DECODE
            r.generated.append(nxt)
            if len(r.generated) >= r.max_new_tokens:
                r.state = STATUS_DONE
                r.t_done = now
                self.completed.append(r)
                self.kv.release(i)
                self.active[i] = None
                sync_point("serve.complete", slot=i, uid=r.uid)
        return True

    def _sample(self, logits: np.ndarray, r: Request) -> int:
        if r.temperature <= 0:
            return int(np.argmax(logits))
        p = np.exp((logits - logits.max()) / r.temperature)
        p /= p.sum()
        return int(self.rng.choice(len(p), p=p))

    # -- drive -------------------------------------------------------------
    def run(self, max_steps: int = 512) -> List[Request]:
        """Drive until idle or ``max_steps``. Returns every request that
        reached a terminal state since the previous ``run()`` —
        completions and failures; whatever is still pending/active at
        the cap is failed with :class:`DeadlineExceededError`."""
        n_done, n_fail = self._run_mark
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        if self.has_work():
            for i, r in enumerate(self.active):
                if r is not None:
                    self._fail(r, DeadlineExceededError(
                        f"active at step cap {max_steps}"), slot=i)
            while self.pending:
                self._fail(self.pending.pop(0), DeadlineExceededError(
                    f"pending at step cap {max_steps}"))
        self._run_mark = [len(self.completed), len(self.failed)]
        return self.completed[n_done:] + self.failed[n_fail:]

    # -- telemetry ---------------------------------------------------------
    def load(self) -> float:
        """Router load score: occupied slots + queue pressure, weighted
        by KV pool exhaustion."""
        occupied = sum(r is not None for r in self.active)
        pool = self.kv.used_blocks / max(1, self.kv.num_blocks - 1)
        return (occupied + len(self.pending)) / max(1, self.slots) + pool

    def stats(self) -> Dict[str, Any]:
        return {"slots": self.slots,
                "active": sum(r is not None for r in self.active),
                "pending": len(self.pending),
                "admitted": self.admitted,
                "completed": len(self.completed),
                "failed": len(self.failed),
                "steps": self.steps,
                **self.kv.stats()}

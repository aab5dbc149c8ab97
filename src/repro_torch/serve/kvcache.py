"""Block/paged KV-cache manager for the continuous-batching engine.

The device cache (:func:`repro_torch.models.lm.init_paged_cache`) is one
physical pool of fixed-size KV blocks shared by every slot; this module
owns the host-side accounting around it, in numpy exactly as the JAX
package's manager does:

* **Block tables.** Each slot maps logical positions to physical blocks
  through a ``(slots, blocks_per_slot)`` table. Block 0 is the reserved
  always-zero sentinel — empty table entries point at it and the
  allocator never hands it out, so an idle slot's gather reads zeros.
* **Strict reservation.** A request is admitted only when the free pool
  covers its whole budget (prompt + max_new_tokens), so an admitted
  request always runs to completion and backpressure happens at
  admission, never mid-decode.
* **Per-slot clocks.** ``pos[slot]`` counts resident tokens; the engine
  checks ``pos + chunk <= capacity`` before every feed.
* **Zero-epoching.** Recycled physical blocks are queued and zeroed
  inside the next :func:`~repro_torch.models.lm.decode_chunk` call
  (``zero_blocks``), and recycled slots' SSD recurrence is reset the
  same way (``reset_slots``), so no request can observe a predecessor's
  K/V or SSM state. SSD state is cumulative, so for the ssm and hybrid
  families the reset is load-bearing, not just hygiene.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..models import lm
from ..models.config import ModelConfig
from ..obs import gauge

__all__ = ["KVCacheManager"]

# Unlabeled: one cell per manager, summed fleet-wide at export;
# per-manager occupancy stays exact through stats().
_KV_USED = gauge("plane_torch_serve_kv_used_blocks",
                 "KV pool blocks currently reserved by admitted requests")
_KV_FREE = gauge("plane_torch_serve_kv_free_blocks",
                 "KV pool blocks free for admission")


class KVCacheManager:
    """Host-side block allocator + owner of the paged device cache."""

    def __init__(self, cfg: ModelConfig, slots: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 device: Union[str, torch.device, None] = None):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.block_size = block_size
        self.blocks_per_slot = max(1, math.ceil(max_len / block_size))
        # +1 for the sentinel; default pool exactly covers every slot
        self.num_blocks = (num_blocks if num_blocks is not None
                           else slots * self.blocks_per_slot + 1)
        if self.num_blocks < self.blocks_per_slot + 1:
            raise ValueError("pool smaller than one slot's worth of blocks")
        self.cache: Dict[str, Any] = lm.init_paged_cache(
            cfg, slots, self.num_blocks, block_size, device)
        # LIFO free list; block 0 (sentinel) is never allocatable
        self._free: List[int] = list(range(self.num_blocks - 1, 0, -1))
        self.table = np.zeros((slots, self.blocks_per_slot), np.int32)
        self.pos = np.zeros((slots,), np.int32)
        self._owned: List[List[int]] = [[] for _ in range(slots)]
        # physical blocks awaiting zero-epoch in the next decode_chunk
        self._pending_zero: List[int] = []
        self._pending_reset = np.zeros((slots,), bool)
        self._g_used = _KV_USED.cell()
        self._g_free = _KV_FREE.cell()
        self._g_free.set(len(self._free))

    # -- accounting --------------------------------------------------------
    def blocks_for(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_size))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def can_reserve(self, tokens: int) -> bool:
        need = self.blocks_for(tokens)
        return need <= self.blocks_per_slot and need <= len(self._free)

    def capacity(self, slot: int) -> int:
        """Tokens the slot's reserved blocks can hold (<= max_len)."""
        return min(len(self._owned[slot]) * self.block_size, self.max_len)

    # -- lifecycle ---------------------------------------------------------
    def reserve(self, slot: int, tokens: int) -> None:
        """Reserve the slot's whole token budget; caller checked
        :meth:`can_reserve`. Freshly assigned blocks are queued for
        zero-epoching."""
        if self._owned[slot]:
            raise RuntimeError(f"slot {slot} already reserved")
        need = self.blocks_for(tokens)
        if need > len(self._free):
            raise RuntimeError("reserve() without can_reserve()")
        blocks = [self._free.pop() for _ in range(need)]
        self._owned[slot] = blocks
        self.table[slot, :] = 0
        self.table[slot, :need] = blocks
        self.pos[slot] = 0
        self._pending_zero.extend(blocks)
        self._pending_reset[slot] = True
        self._g_used.set(self.used_blocks)
        self._g_free.set(self.free_blocks)

    def advance(self, slot: int, n: int) -> None:
        """Move the slot's clock after a chunk; bounds were checked by
        the engine against :meth:`capacity` before feeding."""
        new = int(self.pos[slot]) + n
        if new > self.capacity(slot):
            raise RuntimeError(
                f"slot {slot} clock {new} past capacity {self.capacity(slot)}")
        self.pos[slot] = new

    def release(self, slot: int) -> None:
        """Recycle the slot: blocks return to the pool (zero-epoched on
        their next reservation), the table points back at the sentinel."""
        self._free.extend(reversed(self._owned[slot]))
        self._owned[slot] = []
        self.table[slot, :] = 0
        self.pos[slot] = 0
        self._g_used.set(self.used_blocks)
        self._g_free.set(self.free_blocks)

    # -- per-tick device-side hygiene -------------------------------------
    def take_zero_blocks(self) -> Optional[np.ndarray]:
        """Fixed-size (slots * blocks_per_slot,) index array of physical
        blocks to zero this tick, padded with num_blocks (dropped inside
        decode_chunk); None when nothing is pending."""
        if not self._pending_zero:
            return None
        width = self.slots * self.blocks_per_slot
        out = np.full((width,), self.num_blocks, np.int32)
        take = self._pending_zero[:width]
        out[:len(take)] = take
        del self._pending_zero[:len(take)]
        return out

    def take_reset_slots(self) -> Optional[np.ndarray]:
        """(slots,) bool mask of slots whose SSD state and conv window
        reset this tick (slots reserved since the last tick); None when
        none. The dense family has no recurrent state to reset."""
        if not self._pending_reset.any():
            return None
        out = self._pending_reset.copy()
        self._pending_reset[:] = False
        return out

    def stats(self) -> Dict[str, int]:
        return {"free_blocks": self.free_blocks,
                "used_blocks": self.used_blocks,
                "num_blocks": self.num_blocks - 1,
                "block_size": self.block_size}

"""Training batches: a frozen copy of the port's ``data/pipeline.py``.

The same batches, bit for bit, for the same (config, seed, step, shard)
as ``repro_torch.data.pipeline.SyntheticLMData``: counter-based numpy
generation (a splitmix hash), so every batch is a pure function of
(seed, step, row). The token stream is a Zipf-ish unigram draw with a
repeating per-row motif. Copied so that a change to the program cannot
change the benchmark's inputs; ``cfg`` is anything with the config's
``vocab_size``, ``frontend``, ``num_codebooks``, ``num_patches`` and
``vit_dim`` attributes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np


def _splitmix(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = x
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


@dataclass
class SyntheticLMData:
    cfg: Any
    global_batch: int
    seq_len: int
    seed: int = 0
    motif_len: int = 16

    def _tokens(self, step: int, rows: np.ndarray) -> np.ndarray:
        """(len(rows), seq_len) int32, deterministic in (seed, step, row)."""
        S = self.seq_len
        base = (np.uint64(self.seed) << np.uint64(32)) ^ np.uint64(step)
        ctr = (rows.astype(np.uint64)[:, None] * np.uint64(1 << 20)
               + np.arange(S, dtype=np.uint64)[None, :]) ^ base
        h = _splitmix(ctr)
        # zipf-ish: squash uniform through a power law
        u = (h >> np.uint64(11)).astype(np.float64) / float(1 << 53)
        V = self.cfg.vocab_size
        tok = np.minimum((V - 1) * (u ** 3.0), V - 1).astype(np.int64)
        # motif: every row repeats a short per-row phrase -> learnable
        motif_src = _splitmix(rows.astype(np.uint64)[:, None]
                              + np.arange(self.motif_len, dtype=np.uint64)[None, :])
        motif = (motif_src % np.uint64(V)).astype(np.int64)
        idx = np.arange(S) % (2 * self.motif_len)
        use_motif = idx < self.motif_len
        motif_full = motif[:, idx % self.motif_len]
        tok = np.where(use_motif[None, :], motif_full, tok)
        return tok.astype(np.int32)

    def batch(self, step: int, shard: int = 0, num_shards: int = 1
              ) -> Dict[str, np.ndarray]:
        """The per-shard slice of the global batch for ``step``."""
        assert self.global_batch % num_shards == 0
        per = self.global_batch // num_shards
        rows = np.arange(shard * per, (shard + 1) * per)
        cfg = self.cfg
        if cfg.frontend == "audio":
            S = self.seq_len
            toks = np.stack([self._tokens(step * 7 + c, rows)[:, :S] % cfg.vocab_size
                             for c in range(cfg.num_codebooks)], axis=-1)
            labels = np.roll(toks, -1, axis=1)
            return {"tokens": toks, "labels": labels}
        toks = self._tokens(step, rows)
        out: Dict[str, np.ndarray] = {
            "tokens": toks, "labels": np.roll(toks, -1, axis=1)}
        if cfg.frontend == "vision":
            h = _splitmix((rows.astype(np.uint64)[:, None, None]
                           + np.uint64(step + 1) * np.uint64(77))
                          + np.arange(cfg.num_patches, dtype=np.uint64)[None, :, None] * np.uint64(131)
                          + np.arange(cfg.vit_dim, dtype=np.uint64)[None, None, :])
            out["patch_embeds"] = ((h >> np.uint64(11)).astype(np.float32)
                                   / float(1 << 53) - 0.5).astype(np.float32)
        return out

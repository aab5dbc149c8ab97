"""Serving traffic from a mix file and a seed.

A length distribution is a log-normal given by its median and mean, as
published for a trace (sigma = sqrt(2 ln(mean / median))), with each
length clipped to [lo, hi]: a prompt longer than the engine's context
holds is cut to it, as a server cuts it, and the quantiles below the cut
stay the source's.

Lengths come in strata: every ``stratum`` consecutive requests hold the
same multiset of (prompt, output) lengths, the quantiles (i + 0.5) /
stratum of the two distributions, paired by a fixed stride, and only
their order within the stratum follows the seed. So every seed offers the
same work in another order, and a window that spans a few strata sees the
source's shape whatever the seed. (Lengths drawn from the seed, one per
band of probability, made runs of different seeds spread two to three
times as widely as the same lengths in another order: the seed changed the
work.) Token ids are drawn uniformly from the vocabulary by the seed.
"""

from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, Iterator, List, Tuple

import numpy as np

_STD = NormalDist()


def sigma(dist: Dict) -> float:
    """The log-normal's sigma from its median and mean."""
    return math.sqrt(2.0 * math.log(float(dist["mean"]) / float(dist["median"])))


def length_at(dist: Dict, u: float) -> int:
    """The length at probability u in (0, 1), clipped to [lo, hi]."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    z = _STD.inv_cdf(min(max(u, 1e-12), 1.0 - 1e-12))
    x = float(dist["median"]) * math.exp(sigma(dist) * z)
    return int(min(max(round(x), dist["lo"]), dist["hi"]))


def stratum_lengths(mix: Dict) -> List[Tuple[int, int]]:
    """The (prompt, output) lengths of one stratum, in a fixed order."""
    n = int(mix["stratum"])
    prompts = [length_at(mix["prompt_len"], (i + 0.5) / n) for i in range(n)]
    outputs = [length_at(mix["output_len"], (i + 0.5) / n) for i in range(n)]
    stride = _coprime_stride(n)
    return [(prompts[i], outputs[(i * stride) % n]) for i in range(n)]


def _coprime_stride(n: int) -> int:
    s = max(1, int(round(n * 0.618)))
    while math.gcd(s, n) != 1:
        s += 1
    return s


class Traffic:
    """An endless, seeded stream of requests: (prompt ids, max_new_tokens)."""

    def __init__(self, mix: Dict, vocab_size: int, seed: int):
        self.mix = mix
        self.vocab = int(vocab_size)
        self.rng = np.random.Generator(np.random.PCG64(int(seed)))
        self.lengths = stratum_lengths(mix)

    def __iter__(self) -> Iterator[Tuple[List[int], int]]:
        while True:
            for j in self.rng.permutation(len(self.lengths)):
                p, o = self.lengths[j]
                ids = self.rng.integers(0, self.vocab, size=p, dtype=np.int64)
                yield ids.tolist(), o

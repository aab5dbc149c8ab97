"""The frozen generators: seeded, repeatable, and the same work per seed."""

import math
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from kndbench import harness, traffic_gen  # noqa: E402
from kndbench.datagen import SyntheticLMData  # noqa: E402


def _cfg(vocab=50280):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(vocab_size=vocab)


def test_data_copy_matches_the_programs_generator():
    from repro_torch.data.pipeline import SyntheticLMData as Program
    for seed, step in ((0, 0), (2**31 + 11, 3), (12345, 17)):
        a = SyntheticLMData(_cfg(), 2, 64, seed=seed).batch(step)
        b = Program(_cfg(), 2, 64, seed=seed).batch(step)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_data_is_a_function_of_the_seed():
    a = SyntheticLMData(_cfg(), 4, 128, seed=2**31 + 5).batch(2)
    b = SyntheticLMData(_cfg(), 4, 128, seed=2**31 + 5).batch(2)
    c = SyntheticLMData(_cfg(), 4, 128, seed=2**31 + 6).batch(2)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert (a["tokens"] != c["tokens"]).mean() > 0.3
    np.testing.assert_array_equal(a["labels"], np.roll(a["tokens"], -1, axis=1))


def _mix():
    return harness.load_json(harness.ROOT / "traffic" / "azure-code-closed64.json")


def _take(seed, n):
    it = iter(traffic_gen.Traffic(_mix(), 32000, seed))
    return [next(it) for _ in range(n)]


def test_traffic_is_a_function_of_the_seed():
    a, b, c = _take(2**32 + 1, 70), _take(2**32 + 1, 70), _take(2**32 + 2, 70)
    assert a == b
    assert [p for p, _ in a] != [p for p, _ in c]
    assert all(0 <= t < 32000 for p, _ in a for t in p)


def test_every_seed_offers_the_same_lengths():
    mix = _mix()
    n = mix["stratum"]
    want = Counter(traffic_gen.stratum_lengths(mix))
    for seed in (1, 2, 2**31 + 3):
        reqs = _take(seed, 2 * n)
        for s in range(2):
            got = Counter((len(p), o) for p, o in reqs[s * n:(s + 1) * n])
            assert got == want
    lengths = traffic_gen.stratum_lengths(mix)
    prompts, outputs = sorted(p for p, _ in lengths), sorted(o for _, o in lengths)
    # the quantiles (i + 0.5) / n of each distribution, clipped
    assert prompts == [traffic_gen.length_at(mix["prompt_len"], (i + 0.5) / n) for i in range(n)]
    assert outputs == [traffic_gen.length_at(mix["output_len"], (i + 0.5) / n) for i in range(n)]
    assert prompts[-1] == mix["prompt_len"]["hi"] and outputs[0] >= mix["output_len"]["lo"]
    assert max(p + o for p, o in lengths) <= mix["max_len"]


def test_lengths_follow_the_sources_median_and_mean():
    # log-normal: median exp(mu), mean exp(mu + sigma^2 / 2)
    mix = _mix()
    for dist in (mix["prompt_len"], mix["output_len"]):
        s = traffic_gen.sigma(dist)
        assert abs(dist["median"] * math.exp(s * s / 2) - dist["mean"]) < 1e-9 * dist["mean"]
        assert traffic_gen.length_at(dist, 0.5) == dist["median"]
    assert traffic_gen.sigma(mix["prompt_len"]) == pytest.approx(0.78918, abs=1e-5)
    assert traffic_gen.sigma(mix["output_len"]) == pytest.approx(1.23875, abs=1e-5)

"""The yardstick's arithmetic against counts worked by hand."""

import json
from pathlib import Path

import pytest

from kndbench import peaks, work

CONFIGS = Path(__file__).resolve().parent / "configs"


def model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


def test_peaks_are_the_data_sheets():
    assert peaks.BF16_FLOPS == 989.4e12
    assert peaks.TF32_FLOPS == 494.7e12
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert peaks.matmul_peak("bfloat16") == 989.4e12
    assert peaks.matmul_peak("float32") == 494.7e12


def test_danube_matmul_params():
    # per layer: q 2560x32x80, k and v 2560x8x80, o 32x80x2560, SwiGLU 3x2560x6912
    layer = 6_553_600 + 2 * 1_638_400 + 6_553_600 + 53_084_160
    assert work.layer_matmul_params(model("h2o-danube-1.8b")) == layer == 69_468_160
    assert work.matmul_params(model("h2o-danube-1.8b")) == 24 * layer + 81_920_000
    assert work.matmul_params(model("h2o-danube-1.8b")) == 1_749_155_840


def test_mamba2_matmul_params():
    # in-projections 1536 x (3072 x, 3072 z, 128 B, 128 C, 48 dt), out 3072 x 1536
    layer = 1536 * 6448 + 3072 * 1536
    assert work.layer_matmul_params(model("mamba2-780m")) == layer == 14_622_720
    # the tied head is the embedding's transpose: 1536 x 50280
    assert work.matmul_params(model("mamba2-780m")) == 48 * layer + 77_230_080


def test_mamba2_ssd_flops_per_token():
    # C.B^T: 128 x 257; per head (48): x 64 x 257, state and output 4 x 128 x 64
    assert work.ssd_flops_per_token(model("mamba2-780m")) == 128 * 257 + 48 * (64 * 257 + 32768)


@pytest.mark.parametrize("window,start,stop,want", [
    (0, 0, 4, 1 + 2 + 3 + 4),
    (4, 0, 6, 1 + 2 + 3 + 4 + 4 + 4),
    (4, 2, 6, 3 + 4 + 4 + 4),
    (0, 5, 7, 6 + 7),
])
def test_causal_key_sum(window, start, stop, want):
    assert work.causal_key_sum({"sliding_window": window}, start, stop) == want


def test_flash_forward_of_a_danube_microbatch():
    # q (2,4096,32,80), k and v (2,4096,8,80) bf16, causal, window 4096:
    # 4 x B x H x d x sum of keys (4096 x 4097 / 2 = 8,390,656)
    flops, nbytes = work.flash_fwd_work((2, 4096, 32, 80), (2, 4096, 8, 80), "bfloat16", 4096)
    assert flops == 4 * 2 * 32 * 80 * 8_390_656 == 171_840_634_880
    # q and out 2 x 41,943,040 B; k and v 2 x 10,485,760 B
    assert nbytes == 104_857_600
    t = work.least_time(flops, nbytes, "bfloat16")
    assert t == pytest.approx(171_840_634_880 / 989.4e12)       # bound by operations
    assert t > nbytes / 3.35e12


def test_ssd_chunk_of_a_mamba2_step():
    # b=8, nc=16, Q=256, N=128, H=48, P=64; x bf16, the rest f32
    flops, nbytes = work.ssd_chunk_work((8, 16, 256, 128), (8, 16, 256, 48, 64), "bfloat16")
    per_chunk = 128 * 256 * 257 + 48 * (64 * 256 * 257 + 2 * 256 * 128 * 64)
    assert flops == 8 * 16 * per_chunk
    x = 8 * 16 * 256 * 48 * 64
    want = (2 * 4 * 8 * 16 * 256 * 128 + 2 * x + 2 * 4 * 8 * 16 * 256 * 48
            + 4 * x + 4 * 8 * 16 * 48 * 128 * 64 + 4 * 8 * 16 * 48)
    assert nbytes == want
    t = work.least_time(flops, nbytes, "float32")
    assert t == pytest.approx(nbytes / 3.35e12)                   # bound by bytes


def test_train_and_serve_flops():
    m = model("h2o-danube-1.8b")
    fwd = 2 * 1_749_155_840 * 4096 + 24 * 4 * 32 * 80 * 8_390_656
    assert work.forward_flops(m, [4096]) == fwd
    assert work.train_step_flops(m, 4, 4096) == 3 * 4 * fwd
    body = 2 * (1_749_155_840 - 81_920_000)
    # a 64-token prompt chunk at 100 that ends the prompt: one sampled row
    keys = sum(range(101, 165))
    want = body * 64 + 24 * 4 * 2560 * keys + 2 * 81_920_000
    assert work.serve_chunk_flops(m, 100, 64, True) == want
    assert work.serve_chunk_flops(m, 100, 64, False) == want - 2 * 81_920_000

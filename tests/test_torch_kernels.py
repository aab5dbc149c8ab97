"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper takes its plain version, which is held against
the JAX wrapper (the Pallas kernel in interpret mode, as the JAX
package's own tests run it) at the shapes of ``test_kernels.py``, with
its tolerances: 2e-5 in f32, 2e-2 in bf16. The CUDA kernels
themselves are compared with their plain versions on the card by
``test_torch_gpu.py`` and by ``chip_smoke.py``; what surrounds them
(the flash wrapper's alignment decision, RMSNorm's row stride) is pure
Python and is tested here on CPU tensors.
"""

import importlib
import pkgutil
import re
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro.kernels.rmsnorm.ops import rmsnorm as jax_rmsnorm
from repro_torch import convert
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.cp_async import aligned_input, cp_async_ready
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.rmsnorm import _ARGS, SOURCE as RMSNORM_SOURCE, row_stride
from repro_torch.kernels.ssd_scan.ops import ssd_chunk

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
DTYPES = ["float32", "bfloat16"]


def tol_for(dtype: str) -> float:
    """test_kernels.py's bounds: 2e-5 in f32, 2e-2 in 16-bit types."""
    return 2e-5 if dtype == "float32" else 2e-2


def make(rng, shape, dtype):
    """The same values on both sides: numpy f32 -> dtype in each framework."""
    a = rng.randn(*shape).astype(np.float32)
    return (jnp.asarray(a).astype(dtype),
            convert.tensor_from_numpy(np.asarray(jnp.asarray(a).astype(dtype)),
                                      device="cpu"))


def max_err(t: "torch.Tensor", j) -> float:
    return float(np.max(np.abs(t.float().numpy() - np.asarray(j, np.float32))))


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(4, 37, 256), (2, 100, 64), (1, 1, 128)])
def test_rmsnorm_matches_jax(dtype, shape):
    rng = np.random.RandomState(0)
    jx, tx = make(rng, shape, dtype)
    js, ts = make(rng, shape[-1:], "float32")
    out = rmsnorm(tx, ts)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    assert max_err(out, jax_rmsnorm(jx, js)) < tol_for(dtype)


@pytest.mark.parametrize("dtype,scale_dtype", [("float16", "float32"),
                                               ("bfloat16", "bfloat16"),
                                               ("float32", "bfloat16")])
def test_rmsnorm_matches_jax_at_the_kernels_other_dtypes(dtype, scale_dtype):
    """x in float16, and a bf16 scale: the dtypes the CUDA kernel takes
    besides f32 x with an f32 scale."""
    rng = np.random.RandomState(3)
    jx, tx = make(rng, (3, 50, 192), dtype)
    js, ts = make(rng, (192,), scale_dtype)
    out = rmsnorm(tx, ts)
    assert out.dtype == tx.dtype and out.shape == tx.shape
    assert max_err(out, jax_rmsnorm(jx, js)) < tol_for(dtype)


@pytest.mark.parametrize("shape,stride,want", [
    ((4, 16, 2560), (40960, 2560, 1), 2560),        # contiguous
    ((4, 16, 2560), (48000, 3000, 1), 3000),        # x[..., :2560] of (4, 16, 3000)
    ((4, 3072), (3200, 1), 3200),                   # a column slice
    ((16, 4, 64), (64, 1024, 1), None),             # transposed leading dims
    ((4, 2, 64), (128, 64, 1), 64),                 # contiguous, 3-d
    ((4, 2, 64), (256, 64, 1), None),               # every other pair of rows
    ((1, 64), (9999, 1), 64),                       # one row
    ((4, 1, 64), (100, 7, 1), 100),                 # a unit dimension's stride
    ((1, 1, 64), (5, 3, 1), 64),
])
def test_rmsnorm_row_stride(shape, stride, want):
    assert row_stride(shape, stride) == want
    if want is not None:      # the stride indexes every row of such a tensor
        base = torch.arange(shape[0] * max(stride[0], 1) * 2 + 64.0)
        x = base.as_strided(shape, stride)
        rows = x.reshape(-1, shape[-1])
        flat = base.as_strided((rows.shape[0], shape[-1]), (want, 1))
        assert torch.equal(rows, flat)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = [
    (2, 128, 4, 2, 64, True, 0),
    (1, 200, 8, 8, 32, True, 0),        # ragged vs block size
    (2, 256, 4, 1, 64, True, 96),       # MQA + sliding window
    (1, 64, 2, 2, 16, False, 0),        # bidirectional
    (1, 96, 6, 3, 32, True, 32),
    (1, 72, 8, 2, 80, True, 48),        # danube's head_dim, GQA, window
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,H,K,d,causal,window", FLASH_CASES)
def test_flash_attention_matches_jax(dtype, B, S, H, K, d, causal, window):
    rng = np.random.RandomState(S + d)
    jq, tq = make(rng, (B, S, H, d), dtype)
    jk, tk = make(rng, (B, S, K, d), dtype)
    jv, tv = make(rng, (B, S, K, d), dtype)
    out = flash_attention(tq, tk, tv, causal, window)
    want = jax_flash(jq, jk, jv, causal, window, 64, 64)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    assert max_err(out, want) < tol_for(dtype)


def test_flash_attention_gradient_matches_jax():
    """The autograd.Function's backward (recomputed through the plain
    version) agrees with jax.grad of the JAX oracle."""
    rng = np.random.RandomState(1)
    jq, tq = make(rng, (1, 64, 2, 16), "float32")
    jk, tk = make(rng, (1, 64, 2, 16), "float32")
    jv, tv = make(rng, (1, 64, 2, 16), "float32")
    tq.requires_grad_(True)
    flash_attention(tq, tk, tv).sum().backward()
    want = jax.grad(lambda q_: jax_attention_ref(q_, jk, jv).sum())(jq)
    assert max_err(tq.grad, want) < 1e-4


def _bf16_view(shape, stride, offset=0):
    """A bf16 view of a fresh (aligned) buffer with the given layout."""
    n = offset + 1 + sum((a - 1) * b for a, b in zip(shape, stride))
    return torch.zeros(n, dtype=torch.bfloat16).as_strided(shape, stride, offset)


def _qkv_heads():
    qkv = torch.zeros(2, 100, 48, 80, dtype=torch.bfloat16)
    return qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]


@pytest.mark.parametrize("make_view,ready", [
    (lambda: torch.zeros(1, 64, 4, 80, dtype=torch.bfloat16), True),
    (lambda: _qkv_heads()[0], True),                 # head slices of a fused qkv
    (lambda: _qkv_heads()[1], True),
    (lambda: _qkv_heads()[2], True),
    # seq stride 324 elements (648 bytes): not a multiple of 16 bytes
    (lambda: _bf16_view((2, 100, 4, 80), (32400, 324, 80, 1)), False),
    # head stride 84 elements
    (lambda: _bf16_view((1, 64, 4, 80), (64 * 336, 336, 84, 1)), False),
    # first element 2 bytes past a 16-byte boundary
    (lambda: _bf16_view((1, 64, 4, 80), (20480, 320, 80, 1), offset=1), False),
    # a batch of one: its (odd) batch stride is never stepped
    (lambda: _bf16_view((1, 64, 4, 64), (7, 256, 64, 1)), True),
    # f32 at the same element strides is aligned: 4-byte elements
    (lambda: torch.zeros(2, 100, 4, 84).as_strided((2, 100, 4, 80),
                                                   (33600, 336, 84, 1)), True),
])
def test_flash_alignment_decision(make_view, ready):
    """Which inputs the bf16 path hands to the kernel as they are, and
    which it copies: cp.async reads 16 bytes at a time."""
    t = make_view()
    assert cp_async_ready(t) is ready
    got = aligned_input(t)
    if ready:
        assert got is t
    else:
        assert got.is_contiguous() and torch.equal(got, t) and cp_async_ready(got)


def test_rmsnorm_launch_struct_matches_the_source():
    """The Python struct of the launch's arguments has the size and the
    field offsets that the CUDA source's static_asserts pin RmsnormArgs to."""
    src = RMSNORM_SOURCE.read_text()
    pinned = {m[0]: int(m[1]) for m in re.findall(
        r"static_assert\((?:sizeof\(RmsnormArgs\)|offsetof\(RmsnormArgs, (\w+)\)) == (\d+)",
        src)}
    assert pinned == {"": 64, "rows": 40, "eps": 56}
    assert _ARGS.size == pinned[""]
    packed = _ARGS.pack(1, 2, 3, 4, 5, 6, 7, 8, 9, 0.5)
    assert struct.unpack_from("<i", packed, pinned["rows"])[0] == 6
    assert struct.unpack_from("<f", packed, pinned["eps"])[0] == 0.5


def test_tensor_from_numpy_defaults_to_the_gpu(monkeypatch):
    """Without a device it asks resolve_device for the GPU, which raises
    where there is none, rather than landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        convert.tensor_from_numpy(np.zeros(3, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_tensor_from_numpy_on_the_cpu_is_bit_exact(dtype):
    a = np.asarray(jnp.asarray(np.random.RandomState(0).randn(5, 7) * 100).astype(dtype))
    t = convert.tensor_from_numpy(a, device="cpu")
    assert t.device.type == "cpu" and tuple(t.shape) == a.shape
    bits = np.uint16 if dtype == "bfloat16" else np.uint32
    assert np.array_equal(t.view(torch.int16 if dtype == "bfloat16" else torch.int32)
                          .numpy().view(bits), a.view(bits))


def test_cpu_path_does_not_count_launches():
    reset_launch_counts()
    x = torch.randn(3, 8)
    rmsnorm(x, torch.ones(8))
    q = torch.randn(1, 8, 2, 16)
    flash_attention(q, q, q)
    c = torch.randn(1, 1, 8, 4)
    ssd_chunk(c, c, torch.randn(1, 1, 8, 2, 8), torch.ones(1, 1, 8, 2),
              -torch.ones(1, 1, 8, 2))
    assert launch_counts() == {"flash_attention": 0, "paged_attention": 0, "rmsnorm": 0,
                               "ssd_chunk": 0}


def test_wrappers_raise_on_devices_without_a_kernel():
    x = torch.empty(2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        rmsnorm(x, torch.empty(8, device="meta"))
    q = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q, q)


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------

def test_every_module_imports_without_triton_or_nvcc():
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    assert "repro_torch.kernels.flash_attention.flash_attention" in names
    for name in names:
        importlib.import_module(name)
    assert "triton" not in sys.modules


def test_port_uses_no_triton():
    """Every kernel of the port is CUDA C++ bound with ctypes."""
    pattern = re.compile(r"^\s*(import|from)\s+triton(\.|\s|$)", re.M)
    files = sorted(SRC.rglob("*.py")) + [SRC.parents[1] / "chip_smoke.py"]
    assert [str(f) for f in files if pattern.search(f.read_text())] == []
    assert sorted(p.relative_to(SRC).as_posix() for p in SRC.rglob("*.cu")) == [
        "kernels/flash_attention/csrc/flash_attention.cu",
        "kernels/paged_attention/csrc/paged_attention.cu",
        "kernels/rmsnorm/csrc/rmsnorm.cu",
        "kernels/ssd_scan/csrc/ssd_chunk.cu"]


def test_port_imports_nothing_of_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted(SRC.rglob("*.py")) + [SRC.parents[1] / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []

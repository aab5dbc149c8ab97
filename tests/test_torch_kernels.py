"""The port's kernel modules against the JAX package's kernels.

On the CPU each wrapper takes its plain version, which is held against
the JAX wrapper (the Pallas kernel in interpret mode, as the JAX
package's own tests run it) at the shapes of ``test_kernels.py``, with
its tolerances: 2e-5 in f32, 2e-2 in bf16. The CUDA and Triton kernels
themselves are compared with their plain versions on the card by
``test_torch_gpu.py`` and by ``chip_smoke.py``.
"""

import importlib
import pkgutil
import re
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
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.ssd_scan.ops import ssd_chunk

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
DTYPES = ["float32", "bfloat16"]


def tol_for(dtype: str) -> float:
    return 2e-2 if dtype == "bfloat16" else 2e-5


def make(rng, shape, dtype):
    """The same values on both sides: numpy f32 -> dtype in each framework."""
    a = rng.randn(*shape).astype(np.float32)
    return (jnp.asarray(a).astype(dtype),
            convert.tensor_from_numpy(np.asarray(jnp.asarray(a).astype(dtype))))


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


def test_cpu_path_does_not_count_launches():
    reset_launch_counts()
    x = torch.randn(3, 8)
    rmsnorm(x, torch.ones(8))
    q = torch.randn(1, 8, 2, 16)
    flash_attention(q, q, q)
    c = torch.randn(1, 1, 8, 4)
    ssd_chunk(c, c, torch.randn(1, 1, 8, 2, 8), torch.ones(1, 1, 8, 2),
              -torch.ones(1, 1, 8, 2))
    assert launch_counts() == {"flash_attention": 0, "rmsnorm": 0, "ssd_chunk": 0}


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


def test_port_imports_nothing_of_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = sorted(SRC.rglob("*.py")) + [SRC.parents[1] / "chip_smoke.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert offenders == []

"""The hand-written kernels against their plain versions, on the card.

Every test here needs a CUDA device (the CUDA and Triton kernels have no
CPU mode) and skips without one. The file imports no JAX, so it runs on
a GPU machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of ``test_kernels.py``: 2e-5 in f32, 2e-2 in bf16.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,D", [(1, 2560), (64, 2560), (4096, 7168)])
def test_rmsnorm_kernel_matches_plain_on_gpu(cuda, dtype, rows, D):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, D, device=cuda, generator=g).to(dtype)
    s = 1 + 0.1 * torch.randn(D, device=cuda, generator=g)
    before = launch_counts()["rmsnorm"]
    out = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert launch_counts()["rmsnorm"] == before + 1
    # The plain version is taken on the same inputs in f32 (its final
    # cast left out): kernel and plain differ in the last f32 bit
    # (reduction order, rsqrt), and two bf16 roundings of such values
    # can land one bf16 step apart, which is 0.03 at |y| >= 4.
    err = float((out.float() - rmsnorm_ref(x.float(), s)).abs().max())
    assert err < (2e-2 if dtype == torch.bfloat16 else 2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,K,d,causal,window", [
    (200, 32, 8, 80, True, 0), (256, 32, 8, 80, True, 64),
    (130, 8, 2, 128, True, 0), (96, 4, 4, 64, False, 0)])
def test_flash_kernel_matches_plain_on_gpu(cuda, dtype, S, H, K, d, causal, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, S, H, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, S, K, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, S, K, d, device=cuda, generator=g).to(dtype)
    out = flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=causal, window=window)
    err = float((out.float() - ref.float()).abs().max())
    assert err < (2e-2 if dtype == torch.bfloat16 else 2e-5)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as head slices of one fused (B, S, H+2K, d) tensor."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 100, 48, 80, device=cuda, generator=g)
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]
    out = flash_attention(q, k, v, True, 0)
    ref = attention_ref(q, k, v, causal=True, window=0)
    assert float((out - ref).abs().max()) < 2e-5


@pytest.mark.gpu
def test_flash_gradient_through_the_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(1, 64, n, 64, device=cuda, generator=g) for n in (4, 2, 2))
    q1 = q.clone().requires_grad_(True)
    flash_attention(q1, k, v).sum().backward()
    q2 = q.clone().requires_grad_(True)
    attention_ref(q2, k, v).sum().backward()
    assert float((q1.grad - q2.grad).abs().max()) < 1e-4

"""The hand-written kernels against their plain versions, on the card,
the checkpoints and trainer of the port on the card, and the mesh path:
the KND runtime's mesh over NCCL and the kernels on DTensors.

Every test here needs a CUDA device (the CUDA kernels have no CPU mode)
and skips without one. The file imports no JAX, so it runs on
a GPU machine that has only PyTorch:

  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are those of ``test_kernels.py``: 2e-5 in f32, 2e-2 in bf16
(and in f16), and 1e-4 for the SSD chunk (3xTF32 on tensor cores; see
its source); at mamba2-like decays the SSD chunk is held to a relative
bound (see ``ssd_inputs``).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.kernels.ssd_scan.ops import ssd_chunk
from repro_torch.kernels.ssd_scan.ref import ssd_chunk_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def tol(dtype) -> float:
    return 2e-5 if dtype == torch.float32 else 2e-2


def rmsnorm_checked(x, s):
    """One call: exactly one launch, and the output against the plain
    version taken on the same inputs in f32 (its final cast left out):
    kernel and plain differ in the last f32 bit (reduction order, rsqrt),
    and two bf16 roundings of such values can land one bf16 step apart,
    which is 0.03 at |y| >= 4."""
    before = launch_counts()["rmsnorm"]
    out = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert launch_counts()["rmsnorm"] == before + 1
    assert out.dtype == x.dtype and out.shape == x.shape
    return float((out.float() - rmsnorm_ref(x.float(), s)).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("rows,D", [
    (1, 2560), (64, 2560), (4096, 7168),
    # mamba2's d_model and gated norm (d_inner), hymba's d_model and d_inner
    (64, 1536), (4, 3072), (2048, 3072), (64, 1600), (2048, 3200),
    # the widest rows: a wide dense model's 7168, and 8192
    (1, 7168), (8192, 7168), (1, 8192), (8192, 8192),
    (3, 1000), (5, 37)])                        # D off the vector width
def test_rmsnorm_kernel_matches_plain_on_gpu(cuda, dtype, rows, D):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(rows, D, device=cuda, generator=g).to(dtype)
    s = 1 + 0.1 * torch.randn(D, device=cuda, generator=g)
    assert rmsnorm_checked(x, s) < tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [1536, 3072, 7168])
def test_rmsnorm_kernel_takes_a_bf16_scale(cuda, dtype, D):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(64, D, device=cuda, generator=g).to(dtype)
    s = (1 + 0.1 * torch.randn(D, device=cuda, generator=g)).to(torch.bfloat16)
    assert rmsnorm_checked(x, s) < tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("view", ["row_slice", "odd_offset", "transposed"])
def test_rmsnorm_kernel_reads_strided_x(cuda, dtype, view):
    """A column slice (evenly spaced rows, read in place by the vector
    path), a slice that starts off a 16-byte boundary (the scalar path),
    and leading dimensions that do not fold (copied first)."""
    g = torch.Generator(device=cuda).manual_seed(2)
    base = torch.randn(4, 16, 3200, device=cuda, generator=g).to(dtype)
    x = {"row_slice": base[..., :3072], "odd_offset": base[..., 1:3073],
         "transposed": base[..., :3072].transpose(0, 1)}[view]
    assert not x.is_contiguous()
    s = 1 + 0.1 * torch.randn(3072, device=cuda, generator=g)
    assert rmsnorm_checked(x, s) < tol(dtype)


@pytest.mark.gpu
def test_rmsnorm_kernel_rejects_dtypes_it_was_not_built_for(cuda):
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(TypeError):
        rmsnorm(x, torch.ones(64, device=cuda, dtype=torch.float16))
    with pytest.raises(TypeError):
        rmsnorm(x.double(), torch.ones(64, device=cuda))


def flash_checked(q, k, v, causal, window):
    before = launch_counts()["flash_attention"]
    out = flash_attention(q, k, v, causal, window)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    # the plain version in f32; cast to q's dtype it is attention_ref(q, k, v).
    # Per row, the largest error over the row's RMS: late rows average many
    # keys, and their small outputs would hide a fault under the absolute
    # bound (the reasoning of chip_smoke.py's FLASH_ROW_REL_TOL)
    ref = attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    row = (out.float() - ref).abs().amax(-1) / ref.pow(2).mean(-1).sqrt()
    assert float(row.max()) <= (1e-4 if q.dtype == torch.float32 else 5e-2)
    return float((out.float() - ref.to(q.dtype).float()).abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,H,K,d,causal,window", [
    (200, 32, 8, 80, True, 0), (256, 32, 8, 80, True, 64),
    (130, 8, 2, 128, True, 0), (96, 4, 4, 64, False, 0),
    (200, 8, 2, 64, True, 0), (256, 4, 1, 128, True, 64), (96, 4, 4, 80, False, 0),
    (333, 25, 5, 64, True, 100),               # hymba's 25/5 grouping, S % 64 != 0
    (300, 8, 2, 80, False, 70),                # a window without causality
    (1, 4, 2, 80, True, 0), (65, 4, 2, 128, True, 0)])
def test_flash_kernel_matches_plain_on_gpu(cuda, dtype, S, H, K, d, causal, window):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, S, H, d, device=cuda, generator=g).to(dtype)
    k = torch.randn(2, S, K, d, device=cuda, generator=g).to(dtype)
    v = torch.randn(2, S, K, d, device=cuda, generator=g).to(dtype)
    assert flash_checked(q, k, v, causal, window) < tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_at_hymbas_prefill(cuda, dtype):
    """hymba-1.5b: 25/5 heads of 64, a 2048-token prompt, window 1024."""
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 2048, 25, 64, device=cuda, generator=g).to(dtype)
    k = torch.randn(1, 2048, 5, 64, device=cuda, generator=g).to(dtype)
    v = torch.randn(1, 2048, 5, 64, device=cuda, generator=g).to(dtype)
    assert flash_checked(q, k, v, True, 1024) < tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """q, k, v as head slices of one fused (B, S, H+2K, d) tensor: aligned,
    so the bf16 path reads them in place."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 100, 48, 80, device=cuda, generator=g).to(dtype)
    q, k, v = qkv[:, :, :32], qkv[:, :, 32:40], qkv[:, :, 40:]
    assert flash_checked(q, k, v, True, 0) < tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("view", ["seq_stride", "offset"])
def test_flash_bf16_copies_misaligned_views(cuda, view):
    """A bf16 view whose sequence stride is not a multiple of 8 elements,
    or whose first element is off a 16-byte boundary: the wrapper copies
    it and the kernel agrees with the plain version."""
    g = torch.Generator(device=cuda).manual_seed(5)
    base = torch.randn(2, 150, 8 * 80 + 4, device=cuda, generator=g).to(torch.bfloat16)
    if view == "seq_stride":
        q = base[..., :640].unflatten(-1, (8, 80))
    else:
        q = base[..., 1:641].unflatten(-1, (8, 80))
    k = torch.randn(2, 150, 2, 80, device=cuda, generator=g).to(torch.bfloat16)
    v = torch.randn(2, 150, 2, 80, device=cuda, generator=g).to(torch.bfloat16)
    assert flash_checked(q, k, v, True, 0) < 2e-2


@pytest.mark.gpu
def test_flash_gradient_through_the_kernel(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(1, 64, n, 64, device=cuda, generator=g) for n in (4, 2, 2))
    q1 = q.clone().requires_grad_(True)
    flash_attention(q1, k, v).sum().backward()
    q2 = q.clone().requires_grad_(True)
    attention_ref(q2, k, v).sum().backward()
    assert float((q1.grad - q2.grad).abs().max()) < 1e-4


def ssd_inputs(dev, b, nc, Q, N, H, P, model_like=False, seed=0, da_scale=0.1):
    """``test_kernels.py``'s distribution (unit normals, dt = softplus(n),
    da = -|n| * da_scale), or with ``model_like`` mamba2's init decays
    da = dt * A, A = -linspace(1, 16, H): there cum reaches -1e3 at
    Q = 256, where cum_i - cum_j carries ~1e-4 relative noise between two
    summation orders of the same f32 sums."""
    g = torch.Generator(device=dev).manual_seed(seed)
    C = torch.randn(b, nc, Q, N, device=dev, generator=g)
    B = torch.randn(b, nc, Q, N, device=dev, generator=g)
    x = torch.randn(b, nc, Q, H, P, device=dev, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, nc, Q, H, device=dev, generator=g))
    if model_like:
        da = dt * -torch.linspace(1.0, 16.0, H, device=dev)
    else:
        da = -torch.randn(b, nc, Q, H, device=dev, generator=g).abs() * da_scale
    return C, B, x, dt, da


def ssd_err(out, ref, relative):
    """Max abs error over the three outputs, or each one's over its own
    largest magnitude (decays underflow to 0 at model-like decays)."""
    errs = []
    for o, r in zip(out, ref):
        e = float((o - r).abs().max())
        errs.append(e / max(float(r.abs().max()), 1e-30) if relative else e)
    return max(errs)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nc,Q,N,H,P", [
    (2, 3, 16, 8, 4, 16), (1, 2, 32, 16, 2, 8), (1, 1, 64, 32, 3, 16)])
def test_ssd_kernel_matches_plain_at_the_jax_test_shapes(cuda, dtype, b, nc, Q, N, H, P):
    C, B, x, dt, da = ssd_inputs(cuda, b, nc, Q, N, H, P)
    x = x.to(dtype)
    before = launch_counts()["ssd_chunk"]
    out = ssd_chunk(C, B, x, dt, da)
    torch.cuda.synchronize()
    assert launch_counts()["ssd_chunk"] == before + 1
    assert all(o.dtype == torch.float32 for o in out)
    assert ssd_err(out, ssd_chunk_ref(C, B, x, dt, da), relative=False) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q", [8, 16, 32])
@pytest.mark.parametrize("N", [4, 8])
@pytest.mark.parametrize("P", [8, 16])
def test_ssd_kernel_matches_plain_at_the_jax_property_shapes(cuda, dtype, Q, N, P):
    """The shapes of test_kernels.py's property test (b 1, nc 2, H 2,
    da = -|n| * 0.05): N = 4 and 8 and P = 8 are padded to 16 inside the
    kernel, Q <= 32 is a part of one 64-row tile."""
    C, B, x, dt, da = ssd_inputs(cuda, 1, 2, Q, N, 2, P, seed=Q * N * P, da_scale=0.05)
    x = x.to(dtype)
    out = ssd_chunk(C, B, x, dt, da)
    torch.cuda.synchronize()
    assert out[0].shape == (1, 2, Q, 2, P) and out[1].shape == (1, 2, 2, N, P)
    assert ssd_err(out, ssd_chunk_ref(C, B, x, dt, da), relative=False) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("view", ["offset", "token_stride", "narrow_rows"])
def test_ssd_kernel_copies_misaligned_views(cuda, view):
    """A bf16 x whose first element is off a 16-byte boundary, or whose
    token stride (H * P + 4 elements) is not a multiple of 16 bytes, and
    C, B of N = 2 (rows 8 bytes apart): the wrapper copies them, the
    kernels agree with the plain version, and their output is bit-equal
    to their output on an aligned contiguous copy of x."""
    from repro_torch.kernels.cp_async import cp_async_ready
    b, nc, Q, N, H, P = 1, 2, 64, 2 if view == "narrow_rows" else 32, 4, 16
    C, B, x, dt, da = ssd_inputs(cuda, b, nc, Q, N, H, P, seed=7)
    g = torch.Generator(device=cuda).manual_seed(8)
    base = torch.randn(b, nc * Q, H * P + 4, device=cuda, generator=g).to(torch.bfloat16)
    if view == "offset":
        x = base[..., 1:H * P + 1].reshape(b, nc, Q, H, P)
    else:
        x = base[..., :H * P].reshape(b, nc, Q, H, P)
    assert not (cp_async_ready(x) and cp_async_ready(C))
    out = ssd_chunk(C, B, x, dt, da)
    ref = ssd_chunk_ref(C, B, x, dt, da)
    assert ssd_err(out, ref, relative=False) < 1e-4
    aligned = ssd_chunk(C, B, x.contiguous(), dt, da)
    assert all(torch.equal(o, a) for o, a in zip(out, aligned))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Q,N,H,P", [(256, 128, 48, 64), (100, 128, 48, 64),
                                     (256, 16, 50, 64), (128, 64, 6, 32), (128, 64, 6, 48)])
def test_ssd_kernel_matches_plain_at_model_shapes(cuda, dtype, Q, N, H, P):
    """mamba2-780m (N=128, H=48, P=64; Q=100 is a 100-token prompt) and
    hymba-1.5b (N=16, H=50) with their init's decays; and heads of P = 32
    and 48, which the kernel's 64-column x tiles hold zero-padded."""
    C, B, x, dt, da = ssd_inputs(cuda, 1, 2, Q, N, H, P, model_like=True)
    x = x.to(dtype)
    out = ssd_chunk(C, B, x, dt, da)
    torch.cuda.synchronize()
    assert ssd_err(out, ssd_chunk_ref(C, B, x, dt, da), relative=True) < 1e-3


@pytest.mark.gpu
def test_ssd_kernel_attrs_reports_every_kernel(cuda):
    """The runtime's registers and local memory per thread for each
    kernel of the loaded library."""
    from repro_torch.kernels.ssd_scan.ssd_scan import KERNELS, kernel_attrs
    attrs = kernel_attrs()
    assert tuple(attrs) == KERNELS
    assert all(0 < a["registers"] <= 255 and a["local_bytes"] >= 0 for a in attrs.values())


@pytest.mark.gpu
def test_ssd_kernel_reads_strided_views(cuda):
    """x as the d_inner slice of the conv output (B, S, d_inner + 2N) and
    C, B as its other two slices, reshaped into chunks, as ssd_apply
    passes them in an f32 model."""
    b, nc, Q, N, H, P = 1, 3, 64, 32, 4, 16
    di = H * P
    g = torch.Generator(device=cuda).manual_seed(3)
    conv = torch.randn(b, nc * Q, di + 2 * N, device=cuda, generator=g)
    x = conv[..., :di].reshape(b, nc, Q, H, P)
    Bm = conv[..., di:di + N].reshape(b, nc, Q, N)
    Cm = conv[..., di + N:].reshape(b, nc, Q, N)
    assert not (x.is_contiguous() or Bm.is_contiguous())
    _, _, _, dt, da = ssd_inputs(cuda, b, nc, Q, N, H, P)
    out = ssd_chunk(Cm, Bm, x, dt, da)
    ref = ssd_chunk_ref(Cm.contiguous(), Bm.contiguous(), x.contiguous(), dt, da)
    assert ssd_err(out, ref, relative=False) < 1e-4


@pytest.mark.gpu
def test_ssd_kernel_rejects_shapes_it_was_not_built_for(cuda):
    C, B, x, dt, da = ssd_inputs(cuda, 1, 1, 16, 256, 2, 16)
    with pytest.raises(ValueError, match="built for"):
        ssd_chunk(C, B, x, dt, da)


# ---------------------------------------------------------------------------
# The autograd wrappers (training) and the light launch (serving)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_gradients_through_the_kernel(cuda, dtype):
    """With x and scale requiring grad the kernel's output carries a
    grad_fn (one launch), and its gradients are the plain version's."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(2, 512, 896, device=cuda, generator=g).to(dtype).requires_grad_(True)
    s = (1 + 0.1 * torch.randn(896, device=cuda, generator=g)).requires_grad_(True)
    dy = torch.randn(2, 512, 896, device=cuda, generator=g).to(dtype)
    before = launch_counts()["rmsnorm"]
    y = rmsnorm(x, s)
    assert y.grad_fn is not None and launch_counts()["rmsnorm"] == before + 1
    got = torch.autograd.grad(y, (x, s), dy)
    want = torch.autograd.grad(rmsnorm_ref(x, s), (x, s), dy)
    assert launch_counts()["rmsnorm"] == before + 1        # the backward launches none
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= 1e-5 * float(b.float().abs().max())


@pytest.mark.gpu
def test_rmsnorm_serving_call_takes_the_light_launch(cuda, monkeypatch):
    """No grad recorded (no_grad, or no input requiring it): one launch
    straight into the kernel, no autograd.Function, no graph."""
    from repro_torch.kernels.rmsnorm import ops

    def refuse(*args):
        raise AssertionError("the serving call went through the autograd wrapper")

    monkeypatch.setattr(ops._RMSNorm, "apply", refuse)
    x = torch.randn(4, 16, 896, device=cuda, dtype=torch.bfloat16)
    s = torch.ones(896, device=cuda, dtype=torch.bfloat16, requires_grad=True)
    before = launch_counts()["rmsnorm"]
    with torch.no_grad():
        y = rmsnorm(x, s)
    assert y.grad_fn is None and launch_counts()["rmsnorm"] == before + 1
    y = rmsnorm(x, s.detach())
    assert y.grad_fn is None and launch_counts()["rmsnorm"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_gradients_through_the_kernel(cuda, dtype):
    """hymba's SSD block at S = 512 (2 chunks of 256, 50 heads, N 16):
    the kernels' outputs carry a grad_fn (one launch), and the gradients
    of all five inputs are the plain version's (the backward recomputes
    through it, so only the order of f32 sums may differ)."""
    C, B, x, dt, da = ssd_inputs(cuda, 1, 2, 256, 16, 50, 64, model_like=True, seed=4)
    ins = [t.requires_grad_(True) for t in (C, B, x.to(dtype), dt, da)]
    g = torch.Generator(device=cuda).manual_seed(5)
    douts = [torch.randn(*shape, device=cuda, generator=g) for shape in
             ((1, 2, 256, 50, 64), (1, 2, 50, 16, 64), (1, 2, 50))]
    before = launch_counts()["ssd_chunk"]
    out = ssd_chunk(*ins)
    assert all(o.grad_fn is not None for o in out)
    got = torch.autograd.grad(out, ins, douts)
    want = torch.autograd.grad(ssd_chunk_ref(*ins), ins, douts)
    assert launch_counts()["ssd_chunk"] == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= 1e-5 * float(b.float().abs().max())
    with torch.no_grad():
        assert all(o.grad_fn is None for o in ssd_chunk(*ins))
    assert launch_counts()["ssd_chunk"] == before + 2


# ---------------------------------------------------------------------------
# Checkpoints and the trainer on the card
# ---------------------------------------------------------------------------

def leaves_equal_on(got, want, device_type):
    from repro_torch.tree import tree_flatten_with_paths
    got, want = tree_flatten_with_paths(got), tree_flatten_with_paths(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, a), (_, b) in zip(got, want):
        assert a.device.type == device_type, key
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert torch.equal(a, b), key


@pytest.mark.gpu
@pytest.mark.parametrize("async_save", [True, False])
def test_checkpoint_round_trips_a_cuda_tree(cuda, tmp_path, async_save):
    """bf16, f32 and int32 leaves on the card: restored bit-equal, on the
    card, with the manifest's dtypes; the host snapshot is taken before
    ``save`` returns, so changing the tree in place afterwards changes
    nothing on disk."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.tree import tree_map
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(64, 80, device=cuda, generator=g).to(torch.bfloat16),
            "opt": {"m": torch.randn(3, 5, device=cuda, generator=g)},
            "step": torch.tensor(7, dtype=torch.int32, device=cuda)}
    want = tree_map(torch.clone, tree)
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    mgr.save(7, tree)
    tree_map(lambda t: t.add_(1), tree)
    out, step = mgr.restore_latest(tree_map(lambda t: torch.zeros((), device=cuda), tree))
    assert step == 7
    leaves_equal_on(out, want, "cuda")


@pytest.mark.gpu
def test_trainer_resumes_bit_equal_on_the_card(cuda, tmp_path):
    """Smoke h2o-danube-1.8b on the card: after fit(3) with a checkpoint
    every 2 steps (the last one holds the final state), a fresh trainer
    from another seed resumes to that state bit for bit, and both then
    take the same next step (loss within 1e-6 relative)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.registry import smoke_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import constant_schedule
    from repro_torch.train.train_step import StepConfig
    from repro_torch.train.trainer import Trainer
    cfg = smoke_config("h2o-danube-1.8b")

    def trainer():
        return Trainer(cfg, AdamW(constant_schedule(1e-3)), SyntheticLMData(cfg, 4, 32),
                       ckpt=CheckpointManager(str(tmp_path)), ckpt_every=2,
                       step_cfg=StepConfig(remat="dots"), device=cuda)

    a = trainer()
    a.init(0)
    assert a.fit(3)["completed"] == 3
    b = trainer()
    b.init(1)
    assert b.resume() == 2
    leaves_equal_on(b.state, a.state, "cuda")
    a.fit(1)
    b.fit(1)
    want = a.history[-1]["loss"]
    assert abs(b.history[-1]["loss"] - want) <= 1e-6 * abs(want)


# ---------------------------------------------------------------------------
# The mesh path: an NCCL group of world size 1, DTensors on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def nccl_mesh(cuda, tmp_path):
    """The KND runtime's 1 x 1 data x model mesh over NCCL, world size 1."""
    import torch.distributed as dist
    from repro_torch.core import AttachmentSpec, DeviceBinding, MeshRuntime
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdzv'}",
                            rank=0, world_size=1)
    spec = AttachmentSpec(("data", "model"), (1, 1), [DeviceBinding("chip0", (0, 0))])
    yield MeshRuntime().execute(spec)
    dist.destroy_process_group()


@pytest.mark.gpu
def test_mesh_runtime_over_nccl(nccl_mesh):
    assert nccl_mesh.device_type == "cuda"
    assert nccl_mesh.mesh_dim_names == ("data", "model")
    assert nccl_mesh.mesh.tolist() == [[0]]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_on_a_dtensor_launches_the_kernel(nccl_mesh, dtype):
    from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(8, 64, 2560, device="cuda", generator=g).to(dtype)
    s = 1 + 0.1 * torch.randn(2560, device="cuda", generator=g)
    xd = distribute_tensor(x, nccl_mesh, [Shard(0), Shard(2)])
    sd = distribute_tensor(s, nccl_mesh, [Replicate(), Replicate()])
    before = launch_counts()["rmsnorm"]
    out = rmsnorm(xd, sd)
    torch.cuda.synchronize()
    assert launch_counts()["rmsnorm"] == before + 1
    assert isinstance(out, DTensor) and out.device.type == "cuda"
    err = float((out.to_local().float() - rmsnorm_ref(x.float(), s)).abs().max())
    assert err < tol(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_on_a_dtensor_launches_the_kernel(nccl_mesh, dtype):
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    g = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn(2, 200, 32, 80, device="cuda", generator=g).to(dtype)
    k = torch.randn(2, 200, 8, 80, device="cuda", generator=g).to(dtype)
    v = torch.randn(2, 200, 8, 80, device="cuda", generator=g).to(dtype)
    qd, kd, vd = (distribute_tensor(t, nccl_mesh, [Shard(0), Shard(1)]) for t in (q, k, v))
    before = launch_counts()["flash_attention"]
    out = flash_attention(qd, kd, vd, True, 0)
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == before + 1
    assert isinstance(out, DTensor) and out.device.type == "cuda"
    ref = attention_ref(q.float(), k.float(), v.float(), causal=True, window=0)
    row = (out.to_local().float() - ref).abs().amax(-1) / ref.pow(2).mean(-1).sqrt()
    assert float(row.max()) <= (1e-4 if dtype == torch.float32 else 5e-2)


@pytest.mark.gpu
def test_ssd_chunk_on_a_dtensor_raises(nccl_mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor
    shapes = [(1, 2, 16, 8), (1, 2, 16, 8), (1, 2, 16, 2, 8), (1, 2, 16, 2), (1, 2, 16, 2)]
    ins = [distribute_tensor(torch.zeros(s, device="cuda"), nccl_mesh,
                             [Replicate(), Replicate()]) for s in shapes]
    before = launch_counts()["ssd_chunk"]
    with pytest.raises(NotImplementedError, match="later slice"):
        ssd_chunk(*ins)
    assert launch_counts()["ssd_chunk"] == before


# ---------------------------------------------------------------------------
# The declarative plane on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_informer_builds_the_mesh_on_the_card(cuda, tmp_path):
    """Under a threaded ControlPlaneRuntime the AttachmentController's
    ``execute(spec)`` runs on an informer worker thread: the mesh is a
    cuda ``DeviceMesh`` over the NCCL group, built off the main thread,
    and the main thread made no collective while it waited."""
    import threading
    import torch.distributed as dist
    from repro_torch import core
    from repro_torch.api import ControlPlane, ControlPlaneRuntime, Workload
    from repro_torch.node import NodePlane
    from repro_torch.topology.tpu import TpuPodSpec, build_tpu_cluster

    threads = []

    class Recording(core.MeshRuntime):
        def execute(self, spec):
            threads.append(threading.current_thread())
            return super().execute(spec)

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdzv'}",
                            rank=0, world_size=1)
    try:
        cluster = build_tpu_cluster(1, TpuPodSpec(x=1, y=1))
        reg = core.DriverRegistry()
        reg.add(core.TpuDriver(cluster)).add(core.IciDriver(cluster))
        plane = ControlPlane.open(str(tmp_path / "state"), reg, cluster,
                                  runtime=Recording("cuda"))
        nodes = NodePlane(plane).start()
        rt = ControlPlaneRuntime(plane).start()
        try:
            plane.submit(plane.planner.make_claim("train", 1))
            plane.submit(Workload(claim="train", axes=[core.AxisSpec("data", 1, "y"),
                                                       core.AxisSpec("model", 1, "x")]),
                         name="train-job")
            wl = plane.wait_for("Workload", "train-job")
        finally:
            rt.stop(timeout=20)
            nodes.stop()
        mesh = wl.status.outputs["mesh"]
        assert mesh.device_type == "cuda" and mesh.mesh.tolist() == [[0]]
        assert len(threads) == 1 and threads[0] is not threading.main_thread()
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
def test_sharded_checkpoint_round_trips_on_the_card(nccl_mesh, tmp_path):
    """Smoke h2o-danube-1.8b's train state as DTensors on the card: saved
    (gathered, rank 0 writes), restored as DTensors on the same mesh and
    placements and into the unsharded state, both bit-equal."""
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.configs.registry import smoke_config
    from repro_torch.parallel.sharding import ShardingRules, use_rules
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import constant_schedule
    from repro_torch.train.train_step import init_train_state
    from repro_torch.tree import tree_flatten_with_paths
    cfg = smoke_config("h2o-danube-1.8b")
    opt = AdamW(constant_schedule(1e-3))
    with use_rules(ShardingRules(mesh=nccl_mesh)):
        state = init_train_state(cfg, opt, 0, "cuda")
        like = init_train_state(cfg, opt, 1, "cuda")
    want = {k: (v.full_tensor() if isinstance(v, DTensor) else v).clone()
            for k, v in tree_flatten_with_paths(state)}
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state)
    back, step = mgr.restore_latest(like)
    plain, _ = restore_checkpoint(str(tmp_path), init_train_state(cfg, opt, 1, "cuda"))
    assert step == 1
    n = 0
    for (key, l), (_, got), (_, p) in zip(tree_flatten_with_paths(like),
                                         tree_flatten_with_paths(back),
                                         tree_flatten_with_paths(plain)):
        if isinstance(l, DTensor):
            n += 1
            assert isinstance(got, DTensor) and got.device_mesh is nccl_mesh
            assert got.placements == l.placements
            got = got.full_tensor()
        assert got.device.type == "cuda" and torch.equal(got, want[key]), key
        assert not isinstance(p, DTensor) and torch.equal(p, want[key]), key
    assert n > 0


@pytest.mark.gpu
def test_train_launcher_mesh_on_the_card(cuda, tmp_path):
    """The train launcher on the KND-planned 1 x 1 mesh over NCCL: the
    same losses and grad norms as without the mesh, bit for bit."""
    from repro_torch.launch import train
    args = ["--smoke", "--steps", "2", "--batch", "4", "--seq", "32"]
    meshed = train.main(args + ["--mesh", "1x1", "--devices", "1",
                                "--state-dir", str(tmp_path / "state"), "--node-plane"])
    plain = train.main(args)
    assert meshed["knd"]["mesh"] == {"data": 1, "model": 1}
    assert meshed["losses"] == plain["losses"]
    assert meshed["grad_norms"] == plain["grad_norms"]

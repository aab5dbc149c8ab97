"""The plain reference against the port at smoke sizes, in float32: the
same weights give the same logits, and the same training steps."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from kndbench import harness, smoke, weights  # noqa: E402
from kndbench.reference import model as ref  # noqa: E402
from kndbench.reference import train as ref_train  # noqa: E402

F32 = {"param_dtype": "float32", "compute_dtype": "float32"}


def _model(family):
    conf = harness.load_json(harness.ROOT / "configs" / (
        "h2o-danube-1.8b.json" if family == "dense" else "mamba2-780m.json"))
    return {**conf["model"], **smoke.MODELS[family], **F32}


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_forward_matches_the_port(family):
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    m = _model(family)
    cfg = ModelConfig(**m)
    params = weights.make(lm.abstract_params(cfg), 2**31 + 9, "cpu")
    toks = torch.randint(0, m["vocab_size"], (1, 80), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _ = lm.forward(cfg, params, {"tokens": toks}, attention_impl="auto", remat="none")
    got = ref.logits_at(m, params, toks[0], torch.arange(80))
    torch.testing.assert_close(got, want[0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_training_matches_the_port(family):
    from repro_torch.models import lm
    from repro_torch.models.config import ModelConfig
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.schedule import cosine_schedule
    from repro_torch.train.train_step import StepConfig, make_train_step
    m = _model(family)
    cfg = ModelConfig(**m)
    job = harness.load_json(harness.ROOT / "traffic" / "train-4k-b4-mb2.json")
    s, a = job["schedule"], job["adamw"]
    opt = AdamW(cosine_schedule(s["peak_lr"], s["warmup_steps"], s["total_steps"]),
                b1=a["b1"], b2=a["b2"], eps=a["eps"], weight_decay=a["weight_decay"])
    step = make_train_step(cfg, opt, StepConfig(microbatches=2, remat="full",
                                                clip_norm=job["clip_norm"]))
    abstract = lm.abstract_params(cfg)
    params = weights.make(abstract, 5, "cpu")
    state = {"params": params, "opt_state": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    g = torch.Generator().manual_seed(4)
    batches = []
    for _ in range(3):
        t = torch.randint(0, m["vocab_size"], (4, 24), generator=g)
        batches.append({"tokens": t, "labels": torch.roll(t, -1, 1)})
    losses = []
    for b in batches:
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    want = ref_train.train(m, job, weights.make(abstract, 5, "cpu"), batches)
    assert losses == pytest.approx(want["losses"], rel=1e-5)
    start = dict(weights.leaves(weights.make(abstract, 5, "cpu")))
    for k, v in weights.leaves(state["params"]):
        got = float(torch.linalg.vector_norm(v - start[k]))
        assert got == pytest.approx(want["change"][k], rel=1e-3, abs=1e-6), k


def test_ssd_by_chunks_is_the_recurrence():
    """The reference's chunked SSD equals the plain recurrence
    h_t = exp(A_t) h_{t-1} + B_t x_t, y_t = C_t h_t, for any chunk."""
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 2, 37, 3, 4, 5
    X = torch.randn(b, l, h, p, generator=g)
    A = -torch.rand(b, l, h, generator=g)
    B = torch.randn(b, l, n, generator=g)
    C = torch.randn(b, l, n, generator=g)
    state = torch.zeros(b, h, p, n)
    ys = []
    for t in range(l):
        state = state * torch.exp(A[:, t])[..., None, None] + X[:, t, :, :, None] * B[:, t, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", state, C[:, t]))
    want = torch.stack(ys, dim=1)
    for block in (1, 4, 16, 64):
        torch.testing.assert_close(ref.ssd(X, A, B, C, block), want, rtol=1e-5, atol=1e-5)

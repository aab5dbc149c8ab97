"""Whole runs of the cells at smoke size on the CPU, past the harness's
look for a card: sound runs come out correct, the lower-precision control
and runs with the timed path broken underneath come out not correct, and
no run loads JAX or the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))

from kndbench import check, harness, smoke  # noqa: E402

CELLS = ["danube-rag", "mamba2-train-4k", "danube-train-4k"]
SEED = 2**31 + 77


def _run(name, control=False):
    c = smoke.cell(name, seed=SEED, seconds=0.5)
    c.control = control
    return harness.driver(c.traffic["kind"]).run(c)


@pytest.fixture(scope="module")
def sound():
    return {name: _run(name, control=True) for name in CELLS}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(sound, name):
    out = sound[name]
    ok, table = check.judge(out["numbers"], smoke.LIMITS[name])
    assert ok, table
    assert out["attempted"] > 0 and out["failed"] == 0
    assert all(v > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(sound, name):
    numbers = sound[name]["numbers"]
    control = {k[len("control_"):]: v for k, v in numbers.items() if k.startswith("control_")}
    ok, table = check.judge(control, smoke.LIMITS[name])
    assert not ok, table
    # and it stands three times clear of the program on some number
    assert any(control[k] >= 3 * numbers[k] for k in smoke.LIMITS[name])


VARIANTS = {"danube-rag": {"control", "fault_altered_token"},
            "mamba2-train-4k": {"control", "fault_half_batch", "fault_unchanged"},
            "danube-train-4k": {"control", "fault_half_batch", "fault_unchanged"}}


@pytest.mark.parametrize("name", CELLS)
def test_control_script_judges_the_control_and_faults(sound, name):
    from kndbench.control import verdicts_of
    verdicts = verdicts_of(sound[name]["numbers"], smoke.LIMITS[name])
    assert set(verdicts) == {"program"} | VARIANTS[name]
    assert verdicts.pop("program")[0]
    assert not any(ok for ok, _ in verdicts.values()), verdicts


def _state_unchanged(orig):
    def make(*a, **kw):
        step = orig(*a, **kw)

        def broken(state, batch):
            _, metrics = step(state, batch)
            return state, metrics
        return broken
    return make


def _half_batch(orig):
    def make(*a, **kw):
        step = orig(*a, **kw)

        def broken(state, batch):
            return step(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return broken
    return make


@pytest.mark.parametrize("name", ["mamba2-train-4k", "danube-train-4k"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch])
def test_broken_train_step_is_not_correct(monkeypatch, name, fault):
    from repro_torch.train import train_step
    monkeypatch.setattr(train_step, "make_train_step", fault(train_step.make_train_step))
    ok, table = check.judge(_run(name)["numbers"], smoke.LIMITS[name])
    assert not ok, table


def test_altered_token_is_not_correct(monkeypatch):
    from repro_torch.serve.engine import ServeEngine
    orig = ServeEngine._sample
    monkeypatch.setattr(ServeEngine, "_sample",
                        lambda self, logits, r: (orig(self, logits, r) + 1) % len(logits))
    ok, table = check.judge(_run("danube-rag")["numbers"], smoke.LIMITS["danube-rag"])
    assert not ok, table


GUARD = """
import json, sys
sys.path[:0] = [{repo!r}, {src!r}]
from kndbench import harness, smoke
c = smoke.cell({name!r}, seed=3, seconds=0.3)
harness.driver(c.traffic["kind"]).run(c)
print(json.dumps(harness.forbidden_modules()))
"""


@pytest.mark.parametrize("name", ["danube-rag", "mamba2-train-4k"])
def test_a_run_loads_no_jax(name):
    code = GUARD.format(repo=str(REPO), src=str(REPO / "src"), name=name)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; sys.path[:0] = [%r, %r]\n"
            "import kndbench.reference.model, kndbench.reference.train\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
            % (str(REPO), str(REPO / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.models.lm", "torch"]) == []
    assert harness.forbidden_modules(["repro.models", "jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib", "repro"]

"""The port's NRI-driven Trainer and train launcher against the JAX
package's, on the CPU.

Smoke h2o-danube-1.8b in f32, AdamW at a constant 1e-3, remat "dots",
data 8 x 32: the JAX trainer's initial state is carried into the port's
(``params_from_jax``), both train 9 steps with a checkpoint every 4, and
each then resumes from the other's directory and trains 2 more. Losses
agree within 1e-4 relative per step, the bound of
``tests/test_torch_train.py::test_train_step_matches_jax``. Then the
counterparts of the JAX trainer tests (driver isolation, fault
injection), the straggler events for one fake clock, the event bus and
the driver base class, and the launcher's report and resume.
"""

import json
import math
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs.registry import smoke_config as jax_smoke_config
from repro.core import drivers as jdrivers
from repro.core import nri as jnri
from repro.data.pipeline import SyntheticLMData as JaxSyntheticLMData
from repro.launch import train as jax_launch_train
from repro.train import trainer as jtrainer
from repro.train.optimizer import AdamW as JaxAdamW
from repro.train.schedule import constant_schedule as jax_constant
from repro.train.train_step import StepConfig as JaxStepConfig
from repro_torch import convert
from repro_torch.ckpt.checkpoint import CheckpointManager, list_checkpoints
from repro_torch.configs.registry import smoke_config
from repro_torch.core import EventBus, Events, KNDDriver
from repro_torch.core import drivers as tdrivers
from repro_torch.core import nri as tnri
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.launch import train as launch_train
from repro_torch.train import trainer as ttrainer
from repro_torch.train.optimizer import AdamW
from repro_torch.train.schedule import constant_schedule
from repro_torch.train.train_step import StepConfig
from repro_torch.train.trainer import FaultInjector, Trainer

ARCH = "h2o-danube-1.8b"
LOSS_REL = 1e-4


def f32(cfg):
    return cfg.replace(param_dtype="float32", compute_dtype="float32")


def port_trainer(ckpt_dir, cfg=None, **kw):
    cfg = cfg or f32(smoke_config(ARCH))
    return Trainer(cfg, AdamW(constant_schedule(1e-3)), SyntheticLMData(cfg, 8, 32),
                   ckpt=CheckpointManager(ckpt_dir), ckpt_every=4,
                   step_cfg=StepConfig(remat="dots"), device="cpu", **kw)


def jax_trainer(ckpt_dir):
    cfg = f32(jax_smoke_config(ARCH))
    return jtrainer.Trainer(cfg, JaxAdamW(jax_constant(1e-3)), JaxSyntheticLMData(cfg, 8, 32),
                            ckpt=JaxCheckpointManager(ckpt_dir), ckpt_every=4,
                            step_cfg=JaxStepConfig(remat="dots"))


def losses(trainer, start):
    return [h["loss"] for h in trainer.history[start:]]


def assert_losses_close(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert math.isfinite(a) and abs(a - b) <= LOSS_REL * abs(b), (i, a, b)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Both trainers after fit(9) with ckpt_every=4, from one state."""
    root = tmp_path_factory.mktemp("trainers")
    jdir, tdir = str(root / "jax"), str(root / "port")
    jt = jax_trainer(jdir)
    jt.init(0)
    tt = port_trainer(tdir)
    tt.init(0)
    tt.state = convert.params_from_jax(jax.tree.map(np.asarray, jt.state), "cpu")
    assert tt.state["step"].dtype == torch.int32
    out_j, out_t = jt.fit(9), tt.fit(9)
    return {"jax_dir": jdir, "port_dir": tdir, "jax": jt, "port": tt,
            "out_jax": out_j, "out_port": out_t}


def test_trainer_losses_match_jax(trained):
    assert trained["out_port"]["completed"] == trained["out_jax"]["completed"] == 9
    assert_losses_close(losses(trained["port"], 0), losses(trained["jax"], 0))
    assert list_checkpoints(trained["port_dir"]) == [4, 8]
    assert list_checkpoints(trained["jax_dir"]) == [4, 8]
    assert [r["step"] for r in trained["port"].telemetry.steps] == list(range(9))


def test_each_side_resumes_from_the_others_checkpoints(trained):
    port = port_trainer(trained["jax_dir"])
    jx = jax_trainer(trained["port_dir"])
    assert port.resume() == 8 and jx.resume() == 8
    # the checkpoint carries the loop's step; the state's step is one more
    assert int(port.state["step"]) == 9 and int(jx.state["step"]) == 9
    port.fit(2)
    jx.fit(2)
    assert [h["step"] for h in port.history] == [9, 10]
    assert_losses_close(losses(port, 0), losses(jx, 0))


class Bomb(KNDDriver):
    name = "bomb"

    def register(self, bus):
        bus.subscribe(Events.STEP_END, lambda e: 1 / 0, self.name)


def small_trainer(**kw):
    cfg = smoke_config("mamba2-780m")
    return Trainer(cfg, AdamW(constant_schedule(1e-3)), SyntheticLMData(cfg, 4, 16),
                   step_cfg=StepConfig(remat="none"), device="cpu", **kw)


def test_driver_isolation():
    """A crashing driver never breaks training (NRI isolation)."""
    t = small_trainer(drivers=[Bomb()])
    t.init()
    out = t.fit(3)
    assert out["completed"] == 3
    assert len(t.bus.failures()) == 3


def test_fault_injection_stops():
    t = small_trainer(drivers=[FaultInjector(fail_at=2)])
    t.init()
    assert t.fit(10) == {"stopped_at": 2, "reason": "node_failure"}


def test_trainer_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = smoke_config(ARCH)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, AdamW(constant_schedule(1e-3)), SyntheticLMData(cfg, 4, 16))


@pytest.mark.parametrize("host", ["", "node-3"])
def test_telemetry_publishes_the_same_straggler_events_as_jax(monkeypatch, host):
    clock = [0.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    durations = [1.0] * 8 + [5.0, 1.0, 1.0, 2.9, 3.5, 1.0] + [0.5] * 6 + [9.0]

    def run(nri, driver):
        clock[0] = 100.0
        bus = nri.EventBus()
        seen = []
        driver.register(bus)
        bus.subscribe(nri.Events.STRAGGLER_DETECTED, lambda e: seen.append(e.context), "seen")
        for step, dt in enumerate(durations):
            bus.publish(nri.Events.STEP_BEGIN, step=step, bus=bus)
            clock[0] += dt
            bus.publish(nri.Events.STEP_END, step=step, bus=bus,
                        metrics={"loss": np.float32(step)})
        return seen, driver.steps

    mine = run(tnri, ttrainer.TelemetryDriver(host=host))
    theirs = run(jnri, jtrainer.TelemetryDriver(host=host))
    assert mine == theirs
    assert [e["step"] for e in mine[0]] == [8, 12, 20]
    assert all(e["host"] == host for e in mine[0])


@pytest.mark.parametrize("parallel", [False, True])
def test_event_bus_isolates_handlers_as_jax(parallel):
    def run(nri):
        bus = nri.EventBus(parallel=parallel)
        bus.subscribe("E", lambda e: e.context["x"] + 1, "a")
        bus.subscribe("E", lambda e: 1 / 0, "b")
        bus.subscribe("E", lambda e: e.context["x"] * 2, "c")
        bus.subscribe("F", lambda e: None, "a")
        first = bus.publish("E", x=3)
        bus.unsubscribe_driver("c")
        bus.publish("E", x=5)
        return ([(r.driver, r.event, r.ok, r.value) for r in first],
                [(r.driver, r.ok, r.value) for r in bus.history],
                [r.driver for r in bus.failures()], bus.subscribers("E"),
                bus.publish("none"))

    assert run(tnri) == run(jnri)
    assert run(tnri)[2] == ["b", "b"]


def test_driver_base_prepares_a_claim_as_jax():
    class Ref:
        def __init__(self, i):
            self.ref = type("R", (), {"id": i})()

    class Claim:
        uid = "u-1"
        prepared = False
        allocation = type("A", (), {"devices": [Ref("chip-0"), Ref("chip-1")]})()

        def config_for(self, name):
            return {"driver": name}

    outs = []
    for mod in (tdrivers, jdrivers):
        d = mod.KNDDriver()
        claim = Claim()
        outs.append((d.node_prepare_resources(claim), claim.prepared, dict(d.prepared),
                     d.bump_inventory(), d.discover(), d.device_class()))
        d.node_unprepare_resources(claim)
        assert claim.prepared is False and d.prepared == {}
    assert outs[0] == outs[1]
    bus = EventBus()
    KNDDriver().register(bus)
    assert bus.subscribers(Events.RUN_POD_SANDBOX) == ["knd"]
    assert bus.subscribers(Events.CREATE_CONTAINER) == ["knd"]


def last_json(text):
    """The JSON object a launcher prints last (indented)."""
    return json.loads(text[text.rindex("\n{") + 1:] if "\n{" in text else text[text.index("{"):])


LAUNCH = ["--smoke", "--steps", "3", "--batch", "4", "--seq", "16", "--ckpt-every", "2"]


def test_launcher_resumes_and_reports_as_jax(tmp_path, capsys, monkeypatch):
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    first = launch_train.main(LAUNCH + ["--device", "cpu", "--ckpt-dir", port_dir])
    second = launch_train.main(LAUNCH + ["--device", "cpu", "--ckpt-dir", port_dir, "--resume"])
    out = capsys.readouterr().out
    assert "[resume] from step 2" in out
    assert last_json(out) == second

    jax_out = []
    for extra in ([], ["--resume"]):
        monkeypatch.setattr(sys, "argv", ["train"] + LAUNCH + ["--ckpt-dir", jax_dir] + extra)
        jax_launch_train.main()
        jax_out.append(capsys.readouterr().out)
    assert "[resume] from step 2" in jax_out[1]
    theirs = [last_json(o) for o in jax_out]

    for mine, ref in zip((first, second), theirs):
        assert set(mine) == set(ref) | {"device"}
        assert mine["device"] == "cpu" and mine["arch"] == ref["arch"]
        assert set(mine["result"]) == set(ref["result"])
        assert mine["result"]["completed"] == ref["result"]["completed"]
        assert math.isfinite(mine["loss_first"]) and math.isfinite(mine["loss_last"])
    assert second["result"]["completed"] == 6
    assert list_checkpoints(port_dir) == list_checkpoints(jax_dir) == [2, 4]


def test_launcher_trains_the_ssm_family(capsys):
    out = launch_train.main(["--arch", "mamba2-780m", "--smoke", "--device", "cpu",
                             "--steps", "2", "--batch", "2", "--seq", "16"])
    assert out["arch"] == smoke_config("mamba2-780m").name
    assert out["result"]["completed"] == 2
    assert math.isfinite(out["loss_first"]) and math.isfinite(out["loss_last"])

"""Trainer: the job runtime wired to KND drivers over the NRI bus.

The port of the JAX package's ``train/trainer.py``. The trainer never
calls checkpoint/telemetry/fault logic directly — it publishes lifecycle
events and *independent drivers* act on them (paper §III.B
composability, applied to the training runtime):

  CheckpointDriver  STEP_END        -> periodic async saves
  TelemetryDriver   STEP_BEGIN/END  -> per-step timing, heartbeats,
                                       straggler detection
  FaultInjector     STEP_BEGIN      -> (tests) simulated node failures

A driver crash is isolated by the bus: training never dies because the
telemetry plugin did (the exact failure mode §II pins on CNI chaining).

As in JAX, a checkpoint carries the loop's step in its directory name
and the state after that step, whose ``step`` leaf is one more; STEP_END
is published before the loss is read back, so the telemetry times the
step's dispatch.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..ckpt.checkpoint import CheckpointManager
from ..core.drivers import KNDDriver
from ..core.nri import Event, EventBus, Events
from ..data.pipeline import SyntheticLMData
from ..device import resolve_device
from ..models.config import ModelConfig
from ..obs import span
from .optimizer import Optimizer
from .train_step import StepConfig, TrainState, init_train_state, make_train_step

__all__ = ["Trainer", "CheckpointDriver", "TelemetryDriver", "FaultInjector"]


class CheckpointDriver(KNDDriver):
    name = "ckpt.repro.dev"

    def __init__(self, manager: CheckpointManager, every: int = 50):
        super().__init__()
        self.manager = manager
        self.every = every

    def register(self, bus: EventBus) -> None:
        bus.subscribe(Events.STEP_END, self.on_step_end, self.name)

    def on_step_end(self, event: Event) -> Any:
        step = int(event.context["step"])
        if step % self.every == 0 and step > 0:
            self.manager.save(step, event.context["state"])
            event.context["bus"].publish(Events.CHECKPOINT_SAVED, step=step)
            return {"saved": step}
        return None


class TelemetryDriver(KNDDriver):
    name = "telemetry.repro.dev"

    def __init__(self, straggler_factor: float = 3.0, host: str = ""):
        super().__init__()
        self.steps: List[Dict[str, Any]] = []
        self.straggler_factor = straggler_factor
        # the host this telemetry daemon reports for; straggler events
        # carry it so an elastic controller can attribute strikes (an
        # empty host only accumulates unattributed strikes)
        self.host = host
        self._t0: Optional[float] = None

    def register(self, bus: EventBus) -> None:
        bus.subscribe(Events.STEP_BEGIN, self.on_begin, self.name)
        bus.subscribe(Events.STEP_END, self.on_end, self.name)

    def on_begin(self, event: Event) -> None:
        self._t0 = time.monotonic()

    def on_end(self, event: Event) -> Any:
        dt = time.monotonic() - (self._t0 or time.monotonic())
        rec = {"step": int(event.context["step"]), "seconds": dt}
        m = event.context.get("metrics") or {}
        if "loss" in m:
            rec["loss"] = float(m["loss"])
        self.steps.append(rec)
        # straggler heuristic: this step took k x the median
        if len(self.steps) >= 8:
            med = float(np.median([s["seconds"] for s in self.steps[-32:]]))
            if dt > self.straggler_factor * med:
                event.context["bus"].publish(
                    Events.STRAGGLER_DETECTED, step=rec["step"],
                    seconds=dt, median=med, host=self.host)
        return rec


class FaultInjector(KNDDriver):
    """Test driver: raises/flags failures at chosen steps."""

    name = "chaos.repro.dev"

    def __init__(self, fail_at: Optional[int] = None, node: str = "node-0"):
        super().__init__()
        self.fail_at = fail_at
        self.node = node
        self.fired = False

    def register(self, bus: EventBus) -> None:
        bus.subscribe(Events.STEP_BEGIN, self.on_begin, self.name)

    def on_begin(self, event: Event) -> None:
        if (self.fail_at is not None and not self.fired
                and int(event.context["step"]) == self.fail_at):
            self.fired = True
            event.context["bus"].publish(Events.NODE_FAILED, node=self.node,
                                         step=int(event.context["step"]))


@dataclass
class Trainer:
    """Runs ``make_train_step`` on ``device`` (``None`` = the GPU; pass
    ``"cpu"`` for the CPU) over ``data``, publishing the step lifecycle
    on ``bus``."""

    cfg: ModelConfig
    optimizer: Optimizer
    data: SyntheticLMData
    bus: EventBus = field(default_factory=EventBus)
    step_cfg: StepConfig = field(default_factory=StepConfig)
    ckpt: Optional[CheckpointManager] = None
    ckpt_every: int = 50
    drivers: List[KNDDriver] = field(default_factory=list)
    grad_transform: Optional[Callable] = None
    device: Optional[Union[str, torch.device]] = None

    state: Optional[TrainState] = None
    history: List[Dict[str, float]] = field(default_factory=list)
    _step_fn: Any = None
    _stop: bool = False

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)
        if self.ckpt is not None:
            self.drivers.append(CheckpointDriver(self.ckpt, self.ckpt_every))
        self.telemetry = TelemetryDriver()
        self.drivers.append(self.telemetry)
        for d in self.drivers:
            d.register(self.bus)
        self.bus.subscribe(Events.NODE_FAILED, self._on_node_failed, "trainer")

    def _on_node_failed(self, event: Event) -> None:
        self._stop = True  # an elastic controller takes over

    # ------------------------------------------------------------------
    def init(self, seed: int = 0) -> None:
        self.state = init_train_state(self.cfg, self.optimizer, seed, self.device)
        self._step_fn = make_train_step(self.cfg, self.optimizer, self.step_cfg,
                                        self.grad_transform)

    def resume(self) -> int:
        """Restore newest committed checkpoint; returns the step."""
        assert self.ckpt is not None
        if self.state is None:
            self.init()
        self.state, step = self.ckpt.restore_latest(self.state)
        return step

    def fit(self, num_steps: int) -> Dict[str, Any]:
        assert self.state is not None, "call init() or resume() first"
        self._stop = False
        start = int(self.state["step"])
        for step in range(start, start + num_steps):
            self.bus.publish(Events.STEP_BEGIN, step=step, bus=self.bus)
            if self._stop:
                return {"stopped_at": step, "reason": "node_failure"}
            with span("train.batch"):
                batch = {k: torch.from_numpy(v).to(self.device)
                         for k, v in self.data.batch(step).items()}
            self.state, metrics = self._step_fn(self.state, batch)
            self.bus.publish(Events.STEP_END, step=step, metrics=metrics,
                             state=self.state, bus=self.bus)
            with span("train.readback"):
                loss = float(metrics["loss"])
            self.history.append({"step": step, "loss": loss})
        if self.ckpt is not None:
            self.ckpt.wait()
        self.bus.publish(Events.JOB_COMPLETED, step=start + num_steps)
        return {"completed": start + num_steps,
                "final_loss": self.history[-1]["loss"] if self.history else None}

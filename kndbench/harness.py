"""What every cell shares: the benchmark file, the cell's files, the
device, the clock, the percentile and the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric lives in a file of its own that is found by the name
``BENCHMARK.json`` gives: ``configs/<config>.json`` (by the entry's
``file``), ``traffic/<traffic>.json``, whose ``kind`` names the runner
``drivers/<kind>.py``, ``cells/<cell>.json`` (the correctness limits) and
``metrics/<metric>.py`` for each per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    """One cell's run: its files' contents and the run's arguments."""
    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Optional[float]]
    seed: int
    seconds: float
    trace: bool
    device: Any = "cuda"
    t0: float = field(default_factory=time.perf_counter)
    control: bool = False        # also run the lower-precision control

    @property
    def model(self) -> Dict[str, Any]:
        return self.config["model"]


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> Dict[str, Any]:
    return load_json(REPO / "BENCHMARK.json")


def workload(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def make_cell(bench: Dict[str, Any], name: str, seed: int, seconds: float,
              trace: bool, t0: float) -> Cell:
    w = workload(bench, name)
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(name=name, config=load_json(REPO / conf["file"]),
                traffic=load_json(ROOT / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(ROOT / "cells" / f"{name}.json")["limits"],
                seed=seed, seconds=seconds, trace=trace, t0=t0)


def driver(kind: str):
    return load_module(ROOT / "drivers" / f"{kind}.py", f"kndbench_driver_{kind}")


def metric_reader(name: str):
    return load_module(ROOT / "metrics" / f"{name}.py",
                       "kndbench_metric_" + name.replace(".", "_"))


def per_layer_metrics(bench: Dict[str, Any], cell: str, e2e: List[str]) -> List[Dict]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    out = []
    for m in bench["per_layer"]:
        if cell in m.get("workloads", [cell] if m["moves"] in e2e else []):
            out.append(m)
    return out


def e2e_metrics(bench: Dict[str, Any], cell: str) -> List[Dict]:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def forbidden_modules(names: Optional[List[str]] = None) -> List[str]:
    """Top-level names, compared whole, of JAX's or the JAX package's
    among ``names`` (default: the modules loaded in this process)."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    sample at or below it."""
    if not values:
        return math.nan
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def power_limit_w() -> Optional[float]:
    """The card's power limit by ``nvidia-smi``, or None where it cannot say."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)

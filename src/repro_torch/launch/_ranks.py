"""Gloo ranks on this host, one process each: the spawner shared by the
train launcher's CPU mesh runs and the elastic run's process groups."""

from __future__ import annotations

import os
import subprocess
import sys
import time
from typing import Callable, List


def spawn(cmd_for_rank: Callable[[int], List[str]], world: int, work: str,
          timeout_s: float, what: str) -> List[str]:
    """Run ``cmd_for_rank(r)`` for every rank ``r < world``, each its own
    process with this package on its path and its output in
    ``work/rank<r>.log``; returns the ranks' logs. A failed rank leaves
    the others waiting in a collective, so the first failure, or the
    timeout, kills the rest and raises with the failed ranks' logs."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [src] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    paths = [os.path.join(work, f"rank{r}.log") for r in range(world)]
    procs = []
    try:
        for r, path in enumerate(paths):
            with open(path, "wb") as out:
                procs.append(subprocess.Popen(
                    cmd_for_rank(r), stdout=out, stderr=subprocess.STDOUT,
                    env=env))
        deadline = time.monotonic() + timeout_s
        while (any(p.poll() is None for p in procs)
               and not any(p.returncode for p in procs)
               and time.monotonic() < deadline):
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = []
    for path in paths:
        with open(path, "rb") as f:
            logs.append(f.read().decode(errors="replace"))
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if failed:
        raise RuntimeError(
            f"{what} ranks {failed} of {world} failed or were stopped after "
            f"{timeout_s}s:\n" + "\n".join(
                f"--- rank {r} (exit {procs[r].returncode})\n{logs[r][-4000:]}"
                for r in failed))
    return logs

"""Run one cell of the benchmark once and print its result line.

  python3 kndbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, traffic and
metrics are found by name through ``BENCHMARK.json``. The run needs as
many CUDA devices as the cell asks for and fails without them; the
program under test is ``repro_torch`` from ``src/``. With ``--trace 0``
the result carries the cell's end-to-end metrics; with ``--trace 1`` a
sub-window is profiled and the result carries its per-layer metrics and
a breakdown. The last line on standard output is the JSON result; the
numbers compared for ``correct`` close standard error.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
for env, sub in (("TORCH_EXTENSIONS_DIR", "build/torch_extensions"),
                 ("TRITON_CACHE_DIR", "build/triton")):
    os.environ[env] = str(REPO / sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from kndbench import check, harness
    from kndbench.harness import log

    bench = harness.benchmark()
    w = harness.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
        log(f"kndbench: {args.workload} needs {w['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    cell = harness.make_cell(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), T0)
    torch.cuda.reset_peak_memory_stats()
    out = harness.driver(cell.traffic["kind"]).run(cell)

    bad = harness.forbidden_modules()
    if bad:
        log(f"kndbench: the run loaded {', '.join(bad)}; no result")
        return 3
    e2e = [m["name"] for m in harness.e2e_metrics(bench, cell.name)]
    metrics = {}
    if args.trace:
        readings = {"counters": out["counters"], "trace": out["trace"]}
        for m in harness.per_layer_metrics(bench, cell.name, e2e):
            v = harness.metric_reader(m["name"]).read(readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in harness.e2e_metrics(bench, cell.name):
            metrics[m["name"]] = {"value": out["metrics"][m["name"]], "unit": m["unit"]}
    correct, checks = check.judge(out["numbers"], cell.limits)
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                         "count": w["chips"], "memory_peak_bytes": out["memory_peak_bytes"],
                         "power_limit_w": harness.power_limit_w()}}
    if args.trace and out["trace"] is not None:
        t = out["trace"]
        result["device"]["busy_s"] = t.busy_s
        result["device"]["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": t.device_ops, "idle_gaps": t.idle_gaps}
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(_clean(result)), flush=True)
    return 0


def _clean(v):
    """JSON-safe: a non-finite float becomes null."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {k: _clean(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_clean(x) for x in v]
    return v


if __name__ == "__main__":
    sys.exit(main())

"""The readings a cell's correctness limits are set from, on the card.

  python3 kndbench/control.py --workload <cell> --seeds 11 12 13 ... \\
      --control-seeds 3 --seconds 10

For each seed, in one process: the cell's set-up and a short window at
its own load (the timed path, as a run drives it), then the comparison
with the plain f32 reference, which gives the program's reading (the
lower one). On the first ``--control-seeds`` seeds the control runs too:
the reference computed one precision below the configuration's (fp8 e4m3
products for bf16), in the program's place; its reading against the f32
reference is the upper one. So do the faults a cell can have (training:
half the batch left out, the state left unchanged; serving: a served
token altered), each in the program's place.

One JSON line per seed, with the program's verdict and that of the
control and of each fault under the cell's own limits
(``cells/<cell>.json``). The exit code is 1 where the program comes out
not correct or the control or a fault comes out correct.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, Tuple  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch
    from kndbench import harness
    if not torch.cuda.is_available():
        harness.log("kndbench control: no CUDA device")
        return 2
    bench = harness.benchmark()
    rc = 0
    for i, seed in enumerate(args.seeds):
        cell = harness.make_cell(bench, args.workload, seed, args.seconds, False,
                                 time.perf_counter())
        cell.control = i < args.control_seeds
        t = time.perf_counter()
        out = harness.driver(cell.traffic["kind"]).run(cell)
        verdicts = verdicts_of(out["numbers"], cell.limits)
        for name, (ok, table) in verdicts.items():
            harness.log(f"{args.workload} seed {seed} {name}: correct {ok} {table}")
            if ok != (name == "program"):
                rc = 1
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t,
                          "correct": {k: ok for k, (ok, _) in verdicts.items()},
                          "numbers": out["numbers"], "metrics": out["metrics"]}),
              flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
    return rc


def verdicts_of(numbers: Dict, limits: Dict) -> Dict[str, Tuple[bool, Dict]]:
    """``check.judge`` on the program's numbers and on those of the
    control and of each fault (``control_<n>``, ``fault_<kind>_<n>``)."""
    from kndbench import check
    out = {"program": check.judge(numbers, limits)}
    tags = {k[:-len(n) - 1] for k in numbers for n in limits
            if k.endswith("_" + n) and k.startswith(("control_", "fault_"))}
    for tag in sorted(t for t in tags if all(f"{t}_{n}" in numbers for n in limits)):
        out[tag] = check.judge({n: numbers[f"{tag}_{n}"] for n in limits}, limits)
    return out


if __name__ == "__main__":
    sys.exit(main())

"""The readings the correctness limits are set from, at a cell's own size.

    python3 bench/control.py --workload <name> --seeds 12 --control-seeds 3

Each seed is one run of the cell through :func:`bench.harness.run_cell`
with a short window (``--seconds``), judged as a benchmark run judges:
``--seeds`` runs of the program (the lower readings: what sound runs
read), then ``--control-seeds`` runs with the control in the program's
place (the upper readings): the traffic's reference with its decision in
bfloat16, the precision below the configuration's float32
(``McDriver.control``).  Prints one JSON line per run (its checks and
``correct``) and a summary: the largest lower and the smallest upper
reading of each number compared.  Needs the card the cell runs on; not
part of a benchmark run.
"""
import argparse
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from bench import harness  # noqa: E402
from bench.manifest import Manifest, load_module  # noqa: E402


def readings(cell, seeds, control_seeds, seconds, device) -> dict:
    control = load_module(cell.driver, cell.traffic["driver"]).DRIVER.control()
    runs = {"lower": [], "upper": []}
    for side, driver, group in (("lower", None, seeds),
                                ("upper", control, control_seeds)):
        for seed in group:
            r = harness.run_cell(cell, seed, seconds, False, device=device,
                                 log=io.StringIO(), driver=driver)
            runs[side].append({"seed": seed, "correct": r["correct"],
                               "calls": r["attempted"],
                               **{k: c["value"]
                                  for k, c in r["checks"].items()}})
            print(json.dumps({side: runs[side][-1]}), flush=True)
    names = [k for k in runs["lower"][0] if k not in
             ("seed", "correct", "calls")] if runs["lower"] else []
    return {"workload": cell.name,
            "lower": {k: max(r[k] for r in runs["lower"]) for k in names},
            "upper": {k: min(r[k] for r in runs["upper"]) for k in names}
            if runs["upper"] else {},
            "control_correct": [r["correct"] for r in runs["upper"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_000_000_000)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = Manifest().cell(args.workload)
    first = args.first_seed
    seeds = range(first, first + args.seeds)
    control = range(first + args.seeds, first + args.seeds
                    + args.control_seeds)
    print(json.dumps({"summary": readings(cell, seeds, control, args.seconds,
                                          args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

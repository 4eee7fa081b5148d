"""The readings the benchmark's limits are set from, on the card.

    python3 bench/calibrate.py control --workload <cell> --seeds 1,2,3 --seconds 10
        For each seed, in one process: the cell's set-up and a short window
        at its own load, then the judge's numbers of the program's tokens
        and of the control's (the reference in the precision below the
        configuration's, at the same positions). One JSON line a seed.
        The largest program reading over a dozen seeds is a limit's lower
        reading, the smallest control reading its upper one.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def control(bench, cell, seeds, seconds):
    from l2sbench import harness
    prec = harness.load_module(harness.BENCH / "reference" / "precision.py",
                               "bench_reference_precision") \
        .control_of(cell.cfg["dtype"])
    for seed in seeds:
        t = time.perf_counter()
        out = harness.run_cell(bench, cell, seed, seconds, False,
                               control=prec)
        print(json.dumps({"seed": seed, "correct": out["correct"],
                          "program": out["program"],
                          "control": out["control"], "precision": prec,
                          "metrics": out["metrics"],
                          "wall_s": time.perf_counter() - t}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("control",))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    from l2sbench import harness
    cell = harness.Cell.find(bench, args.workload)
    control(bench, cell, [int(s) for s in args.seeds.split(",")],
            args.seconds)


if __name__ == "__main__":
    main()

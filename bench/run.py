"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell, its configuration, traffic mix,
limits and metrics are found by name (``BENCHMARK.json``, ``bench/``);
``l2sbench/harness.py`` says where. With ``--trace 0`` the line holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, the
device's busy time over the traced window and a breakdown. The numbers
compared with the plain reference are printed last on standard error,
each beside its limit, and under ``checks``, the line's last key.

Exits 2 without a result where there is no CUDA device, or fewer than the
cell asks for; 3 where JAX or the JAX package was loaded by the time the
window closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache a run makes stays inside the checkout, at a fixed path
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
# one host thread for the host's own math: the client, the scheduler and
# the launches share the main thread, and spinning worker threads only
# take cores from it
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")
sys.path[:0] = [str(ROOT / "bench"), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    import torch
    torch.set_num_threads(1)
    from l2sbench import harness
    cell = harness.Cell.find(bench, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(bench, cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START, chips=chips)
    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the measured process: {found}", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings the limits of ``correct`` are set from: the numbers compared,
run after run, for the program and for its control, in one process.

    python3 benchmark/readings.py --workload yolov3-416.bf16-b128 --seconds 4 \\
        --seeds 11 12 13 [--control]

Each seed is a whole run of the cell (``harness.run_cell``) with a short
window; one JSON line a seed: the numbers with their limits, ``correct`` and
the set-up seconds.  ``--control`` serves the configuration's ``control``
instead of its ``serve`` block: the program's own int8 path (w8a8 with
dynamic scales), the precision below bf16, which the limits must fail.
Needs the card, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def readings(workload: str, seeds: list, seconds: float, control: bool,
             device=None, cell=None) -> list:
    """One dict a seed: seed, correct, the checks, setup_s."""
    import torch

    from benchmark import cells, harness

    cell = cell or cells.load(workload, ROOT)
    device = device or torch.device("cuda", 0)
    out = []
    for seed in seeds:
        t = time.perf_counter()
        res = harness.run_cell(cell, seed, seconds, False, device, t,
                               serve=cell.config["control"]["serve"] if control else None)
        out.append({"workload": cell.name, "seed": seed, "control": control,
                    "correct": res["correct"], "checks": res["checks"],
                    "judged": res["judged"],
                    "setup_s": res["metrics"].get("setup_s", {}).get("value"),
                    "img_per_s": res["metrics"].get("img_per_s", {}).get("value")})
        print(json.dumps(out[-1]), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: no readings", file=sys.stderr)
        return 2
    readings(args.workload, args.seeds, args.seconds, args.control)
    return 0


if __name__ == "__main__":
    sys.exit(main())

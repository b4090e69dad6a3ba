"""One run of one cell of ``BENCHMARK.json`` on the card.

    python3 benchmark/run.py --workload yolov3-416.bf16-b128 --seed 7 --seconds 20 --trace 0

Prints earlier lines (card, power limit, set-up by part, launches, window)
and, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, last, ``checks``:
each number compared with its limit, which also end standard error.
Exits non-zero, printing no result, without a CUDA card (or with fewer
than the cell asks for), or where a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "pytorch_yolo_tpu")


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that belong to JAX or the JAX
    package (whole names: ``pytorch_yolo_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    from benchmark import cells

    cell = cells.load(args.workload, ROOT)
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible: no run",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    t_cuda = time.perf_counter()
    from benchmark import harness

    print(f"start and imports: torch imported at {t_torch - T_START:.3f} s, the card found at "
          f"{t_cuda - T_START:.3f} s, the harness imported at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), T_START)
    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Wall time of the port's int8 (w8a8) forward on the CPU.

    python3 tools/cpu_int8_forward.py --model yolov4 --size 416
    for r in _scratch/parent . . _scratch/parent; do
        python3 tools/cpu_int8_forward.py --root $r; done

Builds ``Detector.load(--model, device="cpu", quant="w8a8")`` (the zoo's
synthetic He-init weights, dynamic scales, the default early skip) and
times its model's forward on one letterboxed batch of seeded uint8 frames:
``--warmup`` calls, then the median, min and max of ``--repeats`` calls
(``time.perf_counter``), on ``--threads`` torch threads.  On the CPU every
kernel wrapper runs its plain version, so this is the cost of the plain
K3/K4/K6 epilogues a user pays when serving int8 without a card.
``--root`` imports the port from another checkout, so that one machine
can time parent, change, change, parent.  Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="yolov4", help="a zoo name or a .cfg path")
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--root", default=ROOT, help="the checkout whose port to import")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    sys.path.insert(0, os.path.abspath(args.root))
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch

    det = Detector.load(args.model, device="cpu", quant="w8a8")
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (args.batch, 480, 640, 3), dtype=np.uint8))
    x = letterbox_batch(frames, args.size)
    times = []
    with torch.no_grad():
        for i in range(args.warmup + args.repeats):
            t0 = time.perf_counter()
            heads = det.model(x)
            if i >= args.warmup:
                times.append(time.perf_counter() - t0)
    print(json.dumps({"root": os.path.abspath(args.root), "model": args.model, "size": args.size,
                      "batch": args.batch, "threads": args.threads,
                      "int8_convs": len(det.model.qconvs), "median_s": statistics.median(times),
                      "min_s": min(times), "max_s": max(times),
                      "finite": all(bool(torch.isfinite(h).all()) for h in heads)}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Host-path and step times of one or more checkouts of the port, in turns
in one process, for A/B runs.

    python3 tools/serve_ab.py [--root DIR [DIR ...]] [--mesh N]

Each ``--root`` (default: this checkout) is imported under a name of its
own (``port0``, ``port1``, ...), so the checkouts share one process, one
CUDA context and one host: what differs between processes on a shared
host (its cores, its other tenants) falls on every checkout alike.  Each
builds its own kernel library.  For yolov3@416 bf16 (He-init weights,
seed 0, 480x640 uint8 frames from numpy seed 0) on cuda:0, each of
``ROUNDS`` rounds takes one reading of every metric from every checkout
in turn, metric by metric, the order of the checkouts reversed every
other round (A B, B A, ...), so slow drifts of the host fall on both:

* ``step_ms``: the batch-128 step on frames already on the card, the
  median of ``STEPS`` steps, each between CUDA events (as
  ``chip_smoke.py`` phase 6);
* ``host_ms``: the host's time to enqueue one step of one frame a mesh
  entry already on the card (``raw_result`` returns once every launch is
  queued), the median of ``ENQUEUES`` with the card idle before each;
* ``stream_ms``: ``detect_stream`` at batch 1, depth 2, of raw host
  frames, ms a frame on the host clock;
* ``stream_host_u8_ms``: the same with the host letterbox and uint8
  transfer (the prepared pipeline);
* ``many_u8_img_s``: ``detect_many(transfer="u8")`` in chunks of 8,
  images a second on the host clock.

One JSON line a round, then one line with each checkout's median, range
and ``paired_ratio`` (the median over the rounds of its reading over the
first checkout's in the same round) of every metric, and the card's name
and power limit.  ``--mesh N`` runs every checkout on a mesh of N entries
of cuda:0 (checkouts that have the batch mesh).  To compare a parent:

    git archive <parent> | tar -x -C _scratch/parent
    python3 tools/serve_ab.py --root _scratch/parent .

Needs one NVIDIA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 12
STEPS = 5            # batch-128 steps a reading
ENQUEUES = 10        # batch-1 enqueues a reading
STREAM_FRAMES = 32   # detect_stream frames a reading
MANY_IMAGES = 32     # detect_many images a reading (4 chunks of 8)
PKG = "pytorch_yolo_tpu_torch"


def _import_port(root: str, name: str):
    """The port of checkout ``root`` as package ``name``."""
    pkg = os.path.join(root, PKG)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _metrics(frames: torch.Tensor, host: list, mesh: int) -> dict:
    """name -> function(det) giving one reading (see the module docstring)."""

    def step(det, x):
        return det.raw_result(x, size=416, conf=0.6, iou=0.45, max_det=300)

    def step_ms(det):
        times = []
        for _ in range(STEPS):
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
            step(det, frames)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    one = frames[:mesh].clone()

    def host_ms(det):
        wall = []
        for _ in range(ENQUEUES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(det, one)
            wall.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return statistics.median(wall)

    stream = (host * (STREAM_FRAMES // len(host) + 1))[:STREAM_FRAMES]

    def stream_ms(det, hp):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = sum(1 for _ in det.detect_stream(iter(stream), size=416, host_preproc=hp,
                                             transfer="u8"))
        return (time.perf_counter() - t0) / n * 1e3

    many = (host * (MANY_IMAGES // len(host) + 1))[:MANY_IMAGES]

    def many_u8_img_s(det):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det.detect_many(many, size=416, batch=8, transfer="u8")
        return len(many) / (time.perf_counter() - t0)

    return {"step_ms": step_ms, "host_ms": host_ms,
            "stream_ms": lambda det: stream_ms(det, False),
            "stream_host_u8_ms": lambda det: stream_ms(det, True),
            "many_u8_img_s": many_u8_img_s}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", nargs="+", default=[ROOT], help="checkouts whose ports to import")
    ap.add_argument("--mesh", type=int, default=1, help="entries of cuda:0 in a batch mesh")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    ports = [_import_port(os.path.abspath(r), f"port{i}") for i, r in enumerate(args.root)]
    with concurrent.futures.ThreadPoolExecutor(len(ports)) as pool:  # nvcc runs in parallel
        list(pool.map(lambda p: p.ops.kernels.build(), ports))
    dev = torch.device("cuda", 0)
    dets = []
    for port in ports:
        port.ops.kernels.load_library()
        kw = dict(dtype=torch.bfloat16, precision="default")
        if args.mesh > 1:
            kw["mesh"] = port.parallel.make_batch_mesh([dev] * args.mesh)
        else:
            kw["device"] = dev
        dets.append(port.Detector.load(os.path.join(ROOT, "cfg", "yolov3.cfg"), **kw))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(rng.integers(0, 256, (128, 480, 640, 3), dtype=np.uint8)).to(dev)
    host = list(frames[:16].cpu().numpy())
    metrics = _metrics(frames, host, args.mesh)
    for det in dets:  # every pipeline built and run once
        for fn in metrics.values():
            fn(det)

    runs = {r: {k: [] for k in metrics} for r in args.root}
    order = list(zip(args.root, dets))
    for rnd in range(ROUNDS):
        line: dict = {"round": rnd}
        for name, fn in metrics.items():
            for root, det in (order if rnd % 2 == 0 else order[::-1]):
                runs[root][name].append(fn(det))
                line.setdefault(root, {})[name] = runs[root][name][-1]
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, timeout=60)
    first = runs[args.root[0]]
    summary = {root: {k: {"median": statistics.median(v), "range": [min(v), max(v)],
                          "paired_ratio": statistics.median(a / b for a, b in zip(v, first[k]))}
                      for k, v in rs.items()} for root, rs in runs.items()}
    print(json.dumps({"summary": summary, "rounds": ROUNDS, "mesh": args.mesh,
                      "card": smi.stdout.strip()}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device time of one serving step of the PyTorch port, by kernel.

    python3 tools/profile_torch_step.py --mode int8sb     # or bf16
    python3 tools/profile_torch_step.py --mode int8sb --mma   # K3/K4 on mma.sync

Runs the configuration of ``chip_smoke.py`` phase 6 (``bf16``: yolov3@416,
bf16, batch 128, 480x640 uint8 frames on the card) or phase 9 (``int8sb``:
the same with ``quant="w8a8"``, static scales from 4 frames), 3 warm-up
steps, then ``--steps`` steps under ``torch.profiler``.  Prints the median
step time (CUDA events, without the profiler), the device time per step
summed over all kernels, the share of the step the device was idle, and
the kernels grouped by what they do, largest first.  ``--mma`` forces K3
and K4 onto the ``mma.sync`` core, for an A/B against the wgmma core.
Needs one NVIDIA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import os
import statistics
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel-name substring -> group, first match wins (names as the profiler
# demangles them)
GROUPS = (("wgmma_kernel<false", "K3 int8 GEMM (wgmma)"),
          ("wgmma_kernel<true", "K4 int8 conv (wgmma)"),
          ("igemm_kernel<false", "K3 int8 GEMM (mma.sync)"),
          ("igemm_kernel<true", "K4 int8 conv (mma.sync)"),
          ("decode_score", "K1 decode+score"), ("nms_keep", "K2 NMS keep"),
          ("conv", "bf16 convs (cuDNN, cuBLAS)"), ("fprop", "bf16 convs (cuDNN, cuBLAS)"),
          ("gemm", "bf16 convs (cuDNN, cuBLAS)"), ("xmma", "bf16 convs (cuDNN, cuBLAS)"),
          ("nvjet", "bf16 convs (cuDNN, cuBLAS)"), ("flip", "letterbox"),
          ("upsample_bilinear", "letterbox"),
          ("div", "divide"), ("round", "round"), ("clamp", "clamp"), ("leaky", "leaky"),
          ("copy", "copies and casts"), ("add", "adds (bias, shortcut)"),
          ("sort", "top-K sort"), ("reduce", "reductions"), ("upsample", "upsample"),
          ("cat", "concat"))


def group_of(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key.lower() in low:
            return group
    return "other"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("bf16", "int8sb"), default="int8sb")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mma", action="store_true", help="force K3/K4 onto the mma.sync core")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.ops import kernels

    if args.mma:  # every K3/K4 call on the mma.sync core
        for name in ("int8_gemm", "int8_conv"):
            fn = getattr(kernels, name)
            setattr(kernels, name, lambda *a, _fn=fn, **kw: _fn(*a, _mma=True, **kw))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    cfg = os.path.join(ROOT, "cfg", "yolov3.cfg")
    kw = {}
    if args.mode == "int8sb":
        calib = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
        kw = dict(quant="w8a8", quant_calib=calib, quant_recipe="none")
    det = Detector.load(cfg, device=dev, dtype=torch.bfloat16, precision="default", **kw)
    frames = torch.from_numpy(rng.integers(0, 256, (128, 480, 640, 3), dtype=np.uint8)).to(dev)

    def step():
        return det.raw_result(frames, size=416, conf=0.6, iou=0.45, max_det=300)

    for _ in range(3):
        step()
    times = []
    for _ in range(10):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.steps):
            step()
        end.record()
        torch.cuda.synchronize()
    window = start.elapsed_time(end)
    by_group: dict = collections.defaultdict(lambda: [0.0, 0])
    others: dict = collections.defaultdict(float)
    total = 0.0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if evt.device_type != torch.autograd.DeviceType.CUDA or not us:
            continue
        if group_of(evt.key) == "other":
            others[evt.key[:90]] += us / 1e3 / args.steps
        g = by_group[group_of(evt.key)]
        g[0] += us / 1e3 / args.steps
        g[1] += evt.count // args.steps
        total += us / 1e3 / args.steps
    card = torch.cuda.get_device_name(0)
    print(f"{args.mode}{' (mma.sync)' if args.mma else ''} on {card}: median step "
          f"{statistics.median(times):.3f} ms over 10 (min {min(times):.3f}); device time "
          f"{total:.2f} ms per step of a {window / args.steps:.2f} ms profiled step, idle "
          f"{max(0.0, 1 - total / (window / args.steps)):.1%}")
    for name, (ms, count) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name:30s} {ms:8.3f} ms  {ms / total:6.1%}  ({count} launches)")
    for name, ms in sorted(others.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    other: {ms:8.3f} ms  {name}")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Device time of one serving step of the PyTorch port, by kernel.

    python3 tools/profile_torch_step.py --mode int8sb     # or bf16
    python3 tools/profile_torch_step.py --mode int8sb --mma   # K3/K4 on mma.sync
    python3 tools/profile_torch_step.py --kernels --root DIR  # K1, K2 of DIR's port

Runs the configuration of ``chip_smoke.py`` phase 6 (``bf16``: yolov3@416,
bf16, batch 128, 480x640 uint8 frames on the card) or phase 9 (``int8sb``:
the same with ``quant="w8a8"``, static scales from 4 frames), 3 warm-up
steps, then ``--steps`` steps under ``torch.profiler``.  Prints the median
step time (CUDA events, without the profiler), the device time per step
summed over all kernels, the share of the step the device was idle, and
the kernels grouped by what they do, largest first.  ``--mma`` forces K3
and K4 onto the ``mma.sync`` core, for an A/B against the wgmma core.

``--kernels`` times K1 and K2 alone at the bf16 step's shapes instead and
prints one JSON line: K1 over the step's three heads in bf16 (where the
port's K1 takes no bf16, the cast to fp32 and K1 on that), K1 on the fp32
heads, K2 on the step's 128 x 300 candidates, on crowded boxes at 128 x 300
and on a 1024-long suppression chain at batch 128; each as ``ms`` (20
back-to-back eager calls between CUDA events, host time included) and
``device_ms`` (the same 20 calls replayed from one CUDA graph), with a
digest of its output.  ``--root`` imports the port from another checkout,
so that one call can run parent, change, change, parent:

    for r in _scratch/parent . . _scratch/parent; do
        python3 tools/profile_torch_step.py --kernels --root $r; done

Needs one NVIDIA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
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


def eager_ms(fn, iters: int = 20) -> float:
    """Mean ms per call of ``iters`` back-to-back calls between CUDA events."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device ms per call of ``iters`` calls captured in one CUDA graph
    and replayed (no host time between launches)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_kernels(det, frames, kernels, root: str) -> dict:
    """K1 and K2 at the bf16 step's shapes (``--kernels``)."""
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch

    spec, dev = det.spec, frames.device
    with torch.no_grad():  # the default fp32 heads: the bf16 convs' values, widened
        heads32 = tuple(det.model(letterbox_batch(frames, 416)))
    heads16 = tuple(h.to(torch.bfloat16) for h in heads32)
    try:
        kernels.decode_score_all(heads16, spec)
        serve, served = (lambda: kernels.decode_score_all(heads16, spec)), "K1 on bf16 heads"
    except ValueError:  # a K1 that takes fp32 only: the cast the pipeline made before it
        serve = lambda: kernels.decode_score_all(  # noqa: E731
            tuple(h.to(torch.float32).contiguous() for h in heads16), spec)
        served = "cast to fp32 + K1"
    rows = serve()
    masked = torch.where(rows[..., 4] > 0.6, rows[..., 7], torch.full_like(rows[..., 7], -1.0))
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    sel = torch.gather(rows, 1, idx[:, :300, None].expand(-1, 300, 8))
    step = (sel[..., :4].contiguous(), (top[:, :300] > 0).contiguous(), sel[..., 6].contiguous())
    rng = np.random.default_rng(1)
    centers = rng.uniform(40, 376, size=(128, 25, 2))
    pick = rng.integers(0, 25, size=(128, 300))
    cxy = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 8, (128, 300, 2))
    wh = rng.uniform(10, 90, size=(128, 300, 2))
    crowded = (torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
                                .astype(np.float32)).to(dev),
               torch.from_numpy(rng.uniform(size=(128, 300)) > 0.15).to(dev),
               torch.from_numpy(rng.integers(0, 4, (128, 300)).astype(np.float32)).to(dev))
    x = torch.arange(1024, dtype=torch.float32, device=dev)
    row = torch.stack([x, torch.zeros_like(x), x + 3, torch.full_like(x, 10.0)], -1)
    chain = (row.expand(128, 1024, 4).contiguous(),
             torch.ones((128, 1024), dtype=torch.bool, device=dev), None)
    cases = {"k1_serving": serve,
             "k1_fp32": lambda: kernels.decode_score_all(heads32, spec),
             "k2_step": lambda: kernels.nms_keep(step[0], step[1], 0.45, step[2]),
             "k2_crowded": lambda: kernels.nms_keep(crowded[0], crowded[1], 0.45, crowded[2]),
             "k2_chain1024": lambda: kernels.nms_keep(chain[0], chain[1], 0.45)}
    out = {"root": os.path.abspath(root), "card": torch.cuda.get_device_name(0),
           "k1_serving_is": served, "step_valid": int(step[1].sum())}
    for name, fn in cases.items():
        digest = hashlib.sha1(fn().cpu().numpy().tobytes()).hexdigest()[:16]
        out[name] = {"ms": eager_ms(fn), "device_ms": graph_ms(fn), "digest": digest}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("bf16", "int8sb"), default="int8sb")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mma", action="store_true", help="force K3/K4 onto the mma.sync core")
    ap.add_argument("--kernels", action="store_true",
                    help="time K1 and K2 at the bf16 step's shapes (sets --mode bf16)")
    ap.add_argument("--root", default=ROOT, help="the checkout whose port to import")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.ops import kernels

    if args.kernels:
        args.mode = "bf16"

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

    if args.kernels:
        print(json.dumps(time_kernels(det, frames, kernels, args.root)))
        return

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

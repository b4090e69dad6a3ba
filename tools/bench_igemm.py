#!/usr/bin/env python3
"""Time K3/K4 (the int8 GEMM and implicit-GEMM conv) on one NVIDIA GPU.

    python3 tools/bench_igemm.py                  # the four yolov3 shapes, batch 128
    python3 tools/bench_igemm.py --batch 32 --outs f32

For each shape and output (``acc``: the int32 sums; ``fixed``: the int8
probe's fixed-point requant; ``f32[:act]`` and ``i8[:act]``: the serving
epilogue to fp32 or int8, leaky unless an activation is named) it
times the wgmma core and the ``mma.sync`` core in turns (old, new, new,
old), each two ways: eager calls between CUDA events (host time between
launches included, as a caller sees it) and the same calls replayed from a
CUDA graph (device time only).  It prints each with the bound (ops at
1,979 TOPS or bytes at 3.35 TB/s) and the share of it reached, and checks
the wgmma core against the ``mma.sync`` core bit for bit.  Imports nothing
of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEAK_INT8_OPS, PEAK_HBM_BYTES = 1.979e15, 3.35e12
SHAPES = {"1x1 52² 256->128": (1, 1, 52, 256, 128), "3x3 s1 52² 128->256": (3, 1, 52, 128, 256),
          "3x3 s2 104²->52² 128->256": (3, 2, 104, 128, 256),
          "3x3 s1 13² 512->1024": (3, 1, 13, 512, 1024),
          # the 13² conv's GEMM on K3: both operands by TMA, no gather
          "1x1 13² 4608->1024": (1, 1, 13, 4608, 1024)}


def eager_ms(fn, iters=20):
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


def graph_ms(fn, iters=20):
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--outs", default="acc,f32,i8",
                    help="comma list of acc, fixed, f32[:act], i8[:act]")
    ap.add_argument("--shapes", default=",".join(list(SHAPES)[:4]),
                    help="comma list of shape names")
    ap.add_argument("--bn", type=int, choices=(128, 256), help="force the wgmma tile width")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    from pytorch_yolo_tpu_torch.ops import kernels

    if args.bn:  # every wgmma call at this tile width (split calls stay at 128)
        plan = kernels.igemm_plan
        kernels.igemm_plan = lambda *a: (lambda core, bn: (core, args.bn if core == "wgmma"
                                                           and not a[3] else bn))(*plan(*a))

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    card = torch.cuda.get_device_name(0)
    for name in args.shapes.split(","):
        k, stride, hw, c, o = SHAPES[name]
        x = torch.from_numpy(rng.integers(-127, 128, (args.batch, hw, hw, c), dtype=np.int8)).to(dev)
        w = torch.from_numpy(rng.integers(-127, 128, (o, k, k, c), dtype=np.int8)).to(dev)
        ws = torch.from_numpy(rng.uniform(0.5, 1.5, o).astype(np.float32) * 1e-4).to(dev)
        b = torch.from_numpy(rng.normal(0, 0.5, o).astype(np.float32)).to(dev)
        sx = torch.tensor(0.025, device=dev)
        for out in args.outs.split(","):
            kind, _, act = out.partition(":")
            epi = {"acc": {"accumulators": True}, "fixed": {"fixed": (10, 181, 8)},
                   "f32": dict(ws=ws, b=b, activation=act or "leaky", sx=sx),
                   "i8": dict(ws=ws, b=b, activation=act or "leaky", sx=sx,
                              out_scale=torch.tensor(0.05, device=dev))}[kind]

            def run(mma, epi=epi):
                if k == 1 and stride == 1:
                    return kernels.int8_gemm(x.view(-1, c), w.view(o, c), _mma=mma, **epi)
                return kernels.int8_conv(x, w, stride, k // 2, _mma=mma, **epi)

            if not torch.equal(run(False), run(True)):
                sys.exit(f"{name} {out}: the wgmma and mma.sync cores disagree")
            res = {}
            for how, timer in (("eager", eager_ms), ("graph", graph_ms)):
                o1 = timer(lambda: run(True))
                n1, n2 = timer(lambda: run(False)), timer(lambda: run(False))
                o2 = timer(lambda: run(True))
                res[how] = ((n1 + n2) / 2, (o1 + o2) / 2)
            ops, nbytes = kernels.igemm_work(tuple(x.shape), tuple(w.shape), stride, k // 2,
                                             {"acc": 4, "fixed": 1, "f32": 4, "i8": 1}[kind])
            bound = max(ops / PEAK_INT8_OPS, nbytes / PEAK_HBM_BYTES) * 1e3
            (ne, oe), (ng, og) = res["eager"], res["graph"]
            bn = f" BN {args.bn}" if args.bn else ""
            print(f"{name} batch {args.batch} out {out}{bn}: wgmma {ng:.4f} ms graph / {ne:.4f} "
                  f"eager ({bound / ng:.1%} of bound), mma.sync {og:.4f} / {oe:.4f}; bound "
                  f"{bound:.4f} ms ({ops / 1e9:.1f} G ops, {nbytes / 1e6:.1f} MB); {card}",
                  flush=True)


if __name__ == "__main__":
    main()

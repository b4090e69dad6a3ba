#!/usr/bin/env python3
"""How close K5 and its plain version come to the exact sum, on the card.

    python3 tools/k5_accuracy.py [--root DIR] [--no-detector]

For five yolov3 conv shapes at batch 8 (K = 1024 to 4608; inputs from a
seeded CUDA generator, He-scaled weights, leaky, fp32 bias ~N(0, 0.5)) it
prints the share of bf16 outputs on which K5 (``ops.kernels.conv_bf16``),
its plain version (``conv_bf16_ref``: cuDNN fp32, TF32 off) and the
float64 sum rounded once to fp32 agree, pair by pair.  The float64 sum is
exact (bf16 products have 16 significant bits), so "= exact" measures
each side's own fp32 rounding error, and "K5 = plain" is what
``chip_smoke.py`` phase 13 gates.

Then, for the whole network, it prints the heads' relative L2 of a bf16
yolov3-tiny @416 (live weights, 2 frames, numpy seed 2) on the card
against the same detector's CPU forward (K5's plain version), twice: with
K5, and with the bf16 conv that K5 replaced (:func:`conv_bf16_cudnn`, the
control).  ``tests/test_torch_cuda.py::test_cuda_bf16_detector_runs_k5``
sets its limit between the two readings.  ``--root`` imports the port
from another checkout (a build with another promotion interval P, say);
``--no-detector`` skips the network.  Needs one NVIDIA GPU; imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

import numpy as np

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = ((8, 52, 128, 256, 3, 1), (8, 52, 256, 512, 3, 2), (8, 26, 512, 1024, 3, 2),
          (8, 13, 1024, 512, 1, 1), (8, 13, 512, 1024, 3, 1))  # N, H=W, C, O, k, stride


def conv_bf16_cudnn(x, w, b, stride, pad, act="linear", shortcut=None):
    """The bf16 conv that K5 replaced, with :func:`ops.kernels.conv_bf16`'s
    arguments: cuDNN's bf16 conv with the bias cast to bf16 (its fp32 sum
    rounded to bf16, the bias added in a second rounded pass), the
    activation on the bf16 values, then the shortcut as a bf16 add."""
    from pytorch_yolo_tpu_torch.models.darknet import apply_activation

    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), b.to(torch.bfloat16),
                 stride=stride, padding=pad)
    y = apply_activation(y, act).permute(0, 2, 3, 1)
    return (y if shortcut is None else y + shortcut).contiguous()


@contextlib.contextmanager
def bf16_conv(conv):
    """Run the bf16 detector's convs through ``conv`` (K5 where None)."""
    from pytorch_yolo_tpu_torch.models import darknet

    kept = darknet.conv_bf16
    darknet.conv_bf16 = conv or kept
    try:
        yield
    finally:
        darknet.conv_bf16 = kept


def tiny_detectors(device):
    """A bf16 yolov3-tiny with live weights on ``device`` and the same
    detector on the CPU (one set of weights, equalized on ``device``)."""
    import pytorch_yolo_tpu_torch as pt
    from pytorch_yolo_tpu_torch.models.zoo import model_spec
    from pytorch_yolo_tpu_torch.weights import (equalize_raw_params, fold_batchnorm,
                                                random_raw_params)

    spec = model_spec("yolov3-tiny")
    params = fold_batchnorm(spec, equalize_raw_params(spec, random_raw_params(spec),
                                                      device=device))
    kw = dict(dtype=torch.bfloat16, precision="default")
    return pt.Detector(spec, params, device=device, **kw), pt.Detector(spec, params,
                                                                      device="cpu", **kw)


def detector_frames() -> np.ndarray:
    return np.random.default_rng(2).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)


def heads_rel_l2(det, cpu, frames, size: int = 416, conv=None) -> list[float]:
    """Each head's relative L2 of ``det``'s forward (its convs through
    ``conv``, K5 where None) against ``cpu``'s on the same letterboxed frames."""
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch

    x = letterbox_batch(torch.from_numpy(frames), size)
    with torch.no_grad():
        with bf16_conv(conv):
            ours = det.model(x.to(det.device))
        ref = cpu.model(x)
    return [float((h.cpu().float() - r.float()).norm() / r.float().norm())
            for h, r in zip(ours, ref)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=ROOT, help="the checkout whose port to import")
    ap.add_argument("--no-detector", action="store_true", help="the conv shapes only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from pytorch_yolo_tpu_torch.ops import kernels

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    print(f"{torch.cuda.get_device_name(0)}, {os.path.abspath(args.root)}: share of equal "
          f"bf16 outputs")
    for n, h, c, o, k, s in SHAPES:
        x = torch.randn((n, h, h, c), device=dev, generator=g).clamp_min(-0.1).to(torch.bfloat16)
        w = (torch.randn((o, k, k, c), device=dev, generator=g)
             * (2.0 / (k * k * c)) ** 0.5).to(torch.bfloat16)
        b = torch.randn(o, device=dev, generator=g) * 0.5
        ours = kernels.conv_bf16(x, w, b, s, k // 2, "leaky")
        plain = kernels.conv_bf16_ref(x, w, b, s, k // 2, "leaky")
        y = F.conv2d(x.double().permute(0, 3, 1, 2), w.double().permute(0, 3, 1, 2), stride=s,
                     padding=k // 2).float() + b[:, None, None]
        exact = F.leaky_relu(y, 0.1).to(torch.bfloat16).permute(0, 2, 3, 1)
        eq = lambda a, r: float((a == r).double().mean())  # noqa: E731
        print(f"  K = {k * k * c:5d}  {n}x{h}² {c}->{o} s{s}: K5 = exact {eq(ours, exact):.5%}, "
              f"plain = exact {eq(plain, exact):.5%}, K5 = plain {eq(ours, plain):.5%}")

    if args.no_detector:
        return
    det, cpu = tiny_detectors(dev)
    frames = detector_frames()
    for name, conv in (("K5", None), ("control: cuDNN bf16 + bf16 bias and activation",
                                      conv_bf16_cudnn)):
        l2 = heads_rel_l2(det, cpu, frames, conv=conv)
        print(f"  bf16 yolov3-tiny @416, live, 2 frames, card vs CPU heads' relative L2, "
              f"{name}: {', '.join(f'{v:.5f}' for v in l2)}")


if __name__ == "__main__":
    main()

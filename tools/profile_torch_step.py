#!/usr/bin/env python3
"""Device time of one serving step of the PyTorch port, by kernel.

    python3 tools/profile_torch_step.py --mode int8sb     # or bf16
    python3 tools/profile_torch_step.py --mode bf16 --model yolov4 --size 608 --batch 64
    python3 tools/profile_torch_step.py --mode int8sb --mma   # K3/K4 on mma.sync
    python3 tools/profile_torch_step.py --kernels --root DIR  # K1-K5 of DIR's port
    python3 tools/profile_torch_step.py --k5 --batch 112 128 136  # K5 and cuDNN alone
    python3 tools/profile_torch_step.py --k6 --root DIR       # K6 alone
    python3 tools/profile_torch_step.py --k5-pad              # K5's "im2col_pad" convs

Runs the configuration of ``chip_smoke.py`` phase 6 (``bf16``: yolov3@416,
bf16, batch 128, 480x640 uint8 frames on the card, every conv on K5) or
phase 9 (``int8sb``:
the same with ``quant="w8a8"``, static scales from 4 frames; ``int8dyn``
with dynamic scales, one ``absmax`` a conv), 3 warm-up
steps, then ``--steps`` steps under ``torch.profiler``.  ``--model`` (a
zoo name or a .cfg path, default yolov3), ``--size`` (default 416) and
``--batch`` (its first value, default 128) set another step: int8sb then
calibrates at that size.  Prints the median step time (CUDA events, without the profiler), the device time per step
summed over all kernels, the share of the step the device was idle, the
device operations (kernels, memsets, copies) a step, and the kernels
grouped by what they do, largest first.  ``--mma`` forces K3
and K4 onto the ``mma.sync`` core, for an A/B against the wgmma core.

``--kernels`` times K1 and K2 alone at the bf16 step's shapes instead and
prints one JSON line: K1 over the step's three heads in bf16 (where the
port's K1 takes no bf16, the cast to fp32 and K1 on that), K1 on the fp32
heads, K2 on the step's 128 x 300 candidates, on crowded boxes at 128 x 300
and on a 1024-long suppression chain at batch 128, and K5 at batch 128 at
every distinct yolov3@416 conv that does not take A by a 2-D TMA box and
at its largest 1x1 (``K5_SHAPES``), and K3/K4 at batch 128 with and
without a [shortcut] operand beside the separate add it replaced
(``SHORTCUT_SHAPES``, device time only); each as ``ms`` (20
back-to-back eager calls between CUDA events, host time included) and
``device_ms`` (the same 20 calls replayed from one CUDA graph), with a
digest of its output.  ``--k5`` times K5 alone at ``K5_SHAPES`` (or the
``--shape`` names given) at each ``--batch``, with no detector, its
``device_ms`` beside the cuDNN bf16 conv + bias + leaky it replaced
(``library_device_ms``), each from a CUDA graph in turns (K5, cuDNN,
cuDNN, K5); one JSON line a batch.  ``--k6`` times K6 alone at batch 128
(``K6_CASES``: yolov3@416's largest int8sb input in fp32, bf16 and per
channel, its two route concats read through, and ``absmax`` with the
scale), each ``device_ms`` from one CUDA graph, beside
``torch.quantize_per_tensor`` (a yardstick: it multiplies by a reciprocal
and rounds to [-128, 127]); one JSON line.  ``--k5-pad`` times K5 alone at
``K5_PAD_SHAPES`` (or the ``--pad-shape`` names given: yolov4x-mish's and
yolov4-p7's C % 64 == 32 3x3 convs at their paths' batches, and other
such C), mish, with no detector: the planned route, the "im2col32" route
(``_route``), the planned route's other tile (``_bn``) and cuDNN's bf16
conv + bf16 bias + mish, each ``device_ms`` from a CUDA graph in turns
(forward, then backward), each K5 output's share bit-equal to the plain
version and the planned one's digest; at the first shape also leaky
against mish on the planned route; one JSON line.  ``--root`` imports the port from another checkout
(with ``--mode``, its step), so that one call can run parent, change,
change, parent:

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
GROUPS = (("k6_tile_kernel<false", "K6 int8 input quantizer"),
          ("k6_tile_kernel<true", "K6 absmax"),
          ("quantize_kernel", "K6 int8 input quantizer"),  # the first K6's names
          ("absmax_kernel", "K6 absmax"),
          ("wgmma_kernel<false", "K3 int8 GEMM (wgmma)"),
          ("wgmma_kernel<true", "K4 int8 conv (wgmma)"),
          ("igemm_kernel<false", "K3 int8 GEMM (mma.sync)"),
          ("igemm_kernel<true", "K4 int8 conv (mma.sync)"),
          ("pk::packed_kernel", "K4 int8 conv (packed RGB stem)"),
          ("conv_bf16_kernel<0", "K5 bf16 conv (gather)"),
          ("conv_bf16_kernel<1", "K5 bf16 conv (TMA A)"),
          ("conv_bf16_kernel<2", "K5 bf16 conv (im2col A)"),
          ("conv_bf16_kernel<4", "K5 bf16 conv (im2col A, C = 32)"),
          ("conv_bf16_kernel<5", "K5 bf16 conv (16-channel boxes)"),
          ("conv_bf16_kernel<7", "K5 bf16 conv (im2col_pad A)"),
          ("conv_bf16_halo", "K5 bf16 conv (halo)"),
          ("conv_bf16_packed", "K5 bf16 conv (packed stem)"),
          ("conv_bf16_kernel<true", "K5 bf16 conv (gather)"),  # before the im2col route
          ("conv_bf16_kernel<false", "K5 bf16 conv (TMA A)"),
          ("decode_score", "K1 decode+score"), ("nms_keep", "K2 NMS keep"),
          ("nms_build", "K2 NMS keep"), ("nms_scan", "K2 NMS keep"),
          ("conv", "bf16 convs (cuDNN, cuBLAS)"), ("fprop", "bf16 convs (cuDNN, cuBLAS)"),
          ("gemm", "bf16 convs (cuDNN, cuBLAS)"), ("xmma", "bf16 convs (cuDNN, cuBLAS)"),
          ("nvjet", "bf16 convs (cuDNN, cuBLAS)"), ("flip", "letterbox"),
          ("upsample_bilinear", "letterbox"),
          ("div", "divide"), ("round", "round"), ("clamp", "clamp"), ("leaky", "leaky"),
          ("copy", "copies and casts"), ("add", "adds (bias, shortcut)"),
          ("sort", "top-K sort"), ("reduce", "reductions"), ("upsample", "upsample"),
          ("max_pool", "maxpool (SPP, the ladder)"), ("cat", "concat"))


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


# K5 at batch 128: every distinct conv of yolov3@416 that does not take A
# by a 2-D TMA box, and its largest 1x1: name -> (H = W, C, O, k, stride)
K5_SHAPES = {"stem 416² 3->32": (416, 3, 32, 3, 1),
             "3x3 s2 416²->208² 32->64": (416, 32, 64, 3, 2),
             "3x3 s1 208² 32->64": (208, 32, 64, 3, 1),
             "3x3 s2 208²->104² 64->128": (208, 64, 128, 3, 2),
             "3x3 s1 104² 64->128": (104, 64, 128, 3, 1),
             "3x3 s2 104²->52² 128->256": (104, 128, 256, 3, 2),
             "3x3 s1 52² 128->256": (52, 128, 256, 3, 1),
             "3x3 s2 52²->26² 256->512": (52, 256, 512, 3, 2),
             "3x3 s1 26² 256->512": (26, 256, 512, 3, 1),
             "3x3 s2 26²->13² 512->1024": (26, 512, 1024, 3, 2),
             "3x3 s1 13² 512->1024": (13, 512, 1024, 3, 1),
             "1x1 52² 256->128": (52, 256, 128, 1, 1)}


def time_k5(kernels, dev, batch: int = 128, names=None, library: bool = False) -> dict:
    """K5 alone at :data:`K5_SHAPES` (those of ``names``, else all): leaky,
    N(0, 1) inputs and He-scaled weights from a seeded generator on the
    card; ``ms`` and ``device_ms`` as for K1 and K2, with a digest of the
    output.  ``library``: ``device_ms`` and the cuDNN bf16 conv + bf16 bias
    + leaky's ``library_device_ms`` from CUDA graphs in turns instead."""
    out = {}
    for name in names or K5_SHAPES:
        h, c, o, k, stride = K5_SHAPES[name]
        g = torch.Generator(device=dev).manual_seed(sum(map(ord, name)))
        x = torch.randn((batch, h, h, c), device=dev, generator=g).to(torch.bfloat16)
        w = (torch.randn((o, k, k, c), device=dev, generator=g)
             * (2.0 / (k * k * c)) ** 0.5).to(torch.bfloat16)
        b = torch.randn(o, device=dev, generator=g) * 0.5
        fn = lambda: kernels.conv_bf16(x, w, b, stride, k // 2, "leaky")  # noqa: E731
        digest = hashlib.sha1(fn().view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        out[name] = {"ms": eager_ms(fn), "device_ms": graph_ms(fn), "digest": digest}
        if library:
            F = torch.nn.functional
            xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view, as the path before K5 ran it
            wc = w.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            bc = b.to(torch.bfloat16)
            lib = lambda: F.leaky_relu(F.conv2d(xc, wc, bc, stride=stride, padding=k // 2),  # noqa: E731
                                       0.1, inplace=True)
            t = [graph_ms(f) for f in (fn, lib, lib, fn)]
            out[name].update(device_ms=(t[0] + t[3]) / 2, library_device_ms=(t[1] + t[2]) / 2)
            del xc, wc, bc
        del x, w, b
        torch.cuda.empty_cache()
    return out


# K5's "im2col_pad" convs (C % 64 == 32, C > 32): yolov4x-mish@640's at
# batch 64 and yolov4-p7@1536's at batch 8, and C = 96 / 224 / 288, which
# no zoo model runs: name -> (batch, H = W, C, O, stride)
K5_PAD_SHAPES = {"x-mish 80² 160->160": (64, 80, 160, 160, 1),
                 "x-mish 160²->80² 160->320": (64, 160, 160, 320, 2),
                 "x-mish 80² 160->320": (64, 80, 160, 320, 1),
                 "x-mish 80²->40² 160->320": (64, 80, 160, 320, 2),
                 "p7 192² 160->160": (8, 192, 160, 160, 1),
                 "p7 384²->192² 160->320": (8, 384, 160, 320, 2),
                 "p7 48² 480->480": (8, 48, 480, 480, 1),
                 "104² 96->128": (64, 104, 96, 128, 1),
                 "52² 96->192": (128, 52, 96, 192, 1),
                 "40² 224->224": (64, 40, 224, 224, 1),
                 "26² 288->576": (128, 26, 288, 576, 1)}


def time_k5_pad(kernels, dev, names=None) -> dict:
    """K5 at :data:`K5_PAD_SHAPES` (those of ``names``, else all), mish, N(0,
    1) inputs and He-scaled weights from a seeded generator on the card:
    ``device_ms`` of the planned route, ``im2col32_device_ms`` of the
    "im2col32" route, ``tile_device_ms`` of the planned route's other tile
    and ``library_device_ms`` of cuDNN's bf16 conv + bf16 bias + mish, from
    CUDA graphs in turns; ``equal`` and the others' ``*_equal``: the share
    of outputs bit-equal to the plain version; at the first shape
    ``leaky_device_ms`` beside ``mish_device_ms`` on the planned route."""
    F = torch.nn.functional
    out = {}
    for j, name in enumerate(names or K5_PAD_SHAPES):
        batch, h, c, o, stride = K5_PAD_SHAPES[name]
        g = torch.Generator(device=dev).manual_seed(sum(map(ord, name)))
        x = torch.randn((batch, h, h, c), device=dev, generator=g).to(torch.bfloat16)
        w = (torch.randn((o, 3, 3, c), device=dev, generator=g)
             * (2.0 / (9 * c)) ** 0.5).to(torch.bfloat16)
        b = torch.randn(o, device=dev, generator=g) * 0.5
        route, bn, _ = kernels.conv_bf16_plan(c, o, 3, 3, stride, 1)
        tile = kernels.CONV_BF16_PAIR_BN if bn != kernels.CONV_BF16_PAIR_BN else 128
        fns = {"": lambda **kw: kernels.conv_bf16(x, w, b, stride, 1, "mish", **kw)}
        if route == "im2col_pad":
            fns["im2col32_"] = lambda: fns[""](_route="im2col32")
            fns["tile_"] = lambda: fns[""](_bn=tile)
        ref = kernels.conv_bf16_ref(x, w, b, stride, 1, "mish")
        row = {"plan": [route, bn], "tile": tile if route == "im2col_pad" else None}
        for key, fn in fns.items():
            y = fn()
            row[key + "equal"] = float((y.view(torch.int16) == ref.view(torch.int16))
                                       .double().mean())
            if not key:
                row["digest"] = hashlib.sha1(y.view(torch.int16).cpu().numpy()
                                             .tobytes()).hexdigest()[:16]
            del y
        del ref
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view, as cuDNN would run it
        wc = w.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        bc = b.to(torch.bfloat16)
        fns["library_"] = lambda: F.mish(F.conv2d(xc, wc, bc, stride=stride, padding=1),
                                         inplace=True)
        order = list(fns)
        times = {k: [] for k in order}
        for key in order + order[::-1]:
            times[key].append(graph_ms(fns[key]))
        for key, t in times.items():
            row[key + "device_ms"] = sum(t) / len(t)
        if j == 0:
            leaky = lambda: kernels.conv_bf16(x, w, b, stride, 1, "leaky")  # noqa: E731
            t = [graph_ms(f) for f in (fns[""], leaky, leaky, fns[""])]
            row.update(mish_device_ms=(t[0] + t[3]) / 2, leaky_device_ms=(t[1] + t[2]) / 2)
        out[name] = row
        del x, w, b, xc, wc, bc, fns
        torch.cuda.empty_cache()
    return out


def time_kernels(det, frames, kernels, root: str) -> dict:
    """K1 and K2 at the bf16 step's shapes, K5 at its shapes, and K3/K4
    with a [shortcut] operand (``--kernels``)."""
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
    out["k5"] = time_k5(kernels, dev)
    out["k34_shortcut"] = time_shortcut(kernels, dev)
    return out


# K3/K4 at batch 128 where int8sb takes a [shortcut] into the epilogue
# (yolov3@416's residual 3x3 convs) and at its 1x1 52² conv:
# name -> (kernel size, stride, input side, input channels, output channels)
SHORTCUT_SHAPES = {"1x1 52² 256->128": (1, 1, 52, 256, 128),
                   "3x3 s1 52² 128->256": (3, 1, 52, 128, 256),
                   "3x3 s1 26² 256->512": (3, 1, 26, 256, 512),
                   "3x3 s1 13² 512->1024": (3, 1, 13, 512, 1024)}


def time_shortcut(kernels, dev, batch: int = 128) -> dict:
    """K3/K4 at :data:`SHORTCUT_SHAPES` (static scale, leaky, fp32 out),
    each ``device_ms`` from one CUDA graph of 20 calls: without an operand
    (``none``), with an fp32 and a bf16 [shortcut] operand where the port's
    K3/K4 take one (``f32``, ``bf16``), and the add an unfused [shortcut]
    runs after the conv (``add``: fp32 output + fp32 operand)."""
    import inspect

    takes_shortcut = "shortcut" in inspect.signature(kernels._igemm).parameters
    gen = torch.Generator(dev).manual_seed(0)
    out = {}
    for name, (k, stride, side, c, o) in SHORTCUT_SHAPES.items():
        xq = torch.randint(-127, 128, (batch, side, side, c), device=dev, generator=gen,
                           dtype=torch.int8)
        wq = torch.randint(-127, 128, (o, k, k, c), device=dev, generator=gen, dtype=torch.int8)
        epi = dict(ws=torch.full((o,), 1e-5, device=dev), b=torch.zeros(o, device=dev),
                   activation="leaky", sx=torch.tensor(0.03, device=dev))

        def conv(**extra):
            if k == 1:
                return kernels.int8_gemm(xq.reshape(-1, c), wq.reshape(o, c), **epi, **extra)
            return kernels.int8_conv(xq, wq, stride, k // 2, **epi, **extra)

        y = conv()
        s32 = torch.randn(y.shape, device=dev, generator=gen)
        row = {"none": graph_ms(conv), "add": graph_ms(lambda: y + s32)}
        if takes_shortcut:
            s16 = s32.to(torch.bfloat16)
            row["f32"] = graph_ms(lambda: conv(shortcut=s32))
            row["bf16"] = graph_ms(lambda: conv(shortcut=s16))
        out[name] = row
        del xq, wq, y, s32
    return out


# K6 at batch 128: name -> (NHWC shapes of the branches, their dtypes,
# scale): yolov3@416 int8sb's largest input, and its two route concats
# (layers 86 and 98: the sources of the conv after each, read through)
K6_CASES = {"fp32 (128, 52, 52, 256)": (((52, 256),), ("float32",), "scalar"),
            "bf16 (128, 52, 52, 256)": (((52, 256),), ("bfloat16",), "scalar"),
            "fp32 per channel (128, 52, 52, 256)": (((52, 256),), ("float32",), "vector"),
            "route 86: 26² 256 + 512 fp32": (((26, 256), (26, 512)), ("float32", "float32"),
                                             "split"),
            "route 98: 52² 128 + 256 fp32": (((52, 128), (52, 256)), ("float32", "float32"),
                                             "split")}


def time_k6(kernels, dev, batch: int = 128) -> dict:
    """K6 alone at :data:`K6_CASES` and ``absmax`` (with the scale, where
    the checkout writes it) at the largest input: ``device_ms``, the bytes
    bound, a digest of the output; the cat + K6 that a checkout without the
    read-through runs on a concat."""
    branches = hasattr(kernels, "MAX_QUANT_BRANCHES")  # the read-through and the scale
    gen = torch.Generator(dev).manual_seed(0)
    out = {}
    for name, (shapes, dtypes, scale) in K6_CASES.items():
        xs = [torch.randn((batch, h, h, c), device=dev, generator=gen).to(getattr(torch, dt))
              for (h, c), dt in zip(shapes, dtypes)]
        c = sum(t.shape[-1] for t in xs)
        if scale == "vector":
            sx = torch.rand(c, device=dev, generator=gen) * 0.04 + 0.01
        elif scale == "split":
            sx = [torch.tensor(0.03 + 0.005 * g, device=dev) for g in range(len(xs))]
        else:
            sx = torch.tensor(0.03, device=dev)
        nbytes = sum(t.numel() * (t.element_size() + 1) for t in xs)
        row = {"bound_ms": nbytes / 3.35e12 * 1e3}
        if len(xs) > 1:  # the concatenated copy and one launch over it
            sv = torch.cat([s.reshape(1).expand(t.shape[-1]) for s, t in zip(sx, xs)])
            row["cat_then_k6"] = graph_ms(lambda: kernels.quantize_i8(torch.cat(xs, -1), sv))
        if len(xs) == 1 or branches:
            arg = xs if len(xs) > 1 else xs[0]
            fn = lambda: kernels.quantize_i8(arg, sx)  # noqa: E731
            digest = hashlib.sha1(fn().cpu().numpy().tobytes()).hexdigest()[:16]
            row["kernel"] = {"device_ms": graph_ms(fn), "digest": digest}
        if scale == "scalar" and dtypes == ("float32",):
            x6 = xs[0]
            row["quantize_per_tensor"] = graph_ms(
                lambda: torch.quantize_per_tensor(x6, 0.03, 0, torch.qint8))
        out[name] = row
        del xs
    x = torch.randn((batch, 52, 52, 256), device=dev, generator=gen)
    am = {"bound_ms": x.numel() * 4 / 3.35e12 * 1e3}
    am["kernel"] = graph_ms(lambda: kernels.absmax(x, scale=True) if branches
                            else kernels.absmax(x))
    out["absmax fp32 (128, 52, 52, 256)"] = am
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=("bf16", "int8sb", "int8dyn"), default="int8sb")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mma", action="store_true", help="force K3/K4 onto the mma.sync core")
    ap.add_argument("--kernels", action="store_true",
                    help="time K1-K5 alone at the step's shapes (sets --mode bf16)")
    ap.add_argument("--k5", action="store_true",
                    help="time K5 and cuDNN alone at each --batch (no detector)")
    ap.add_argument("--k6", action="store_true",
                    help="time K6 alone at K6_CASES (no detector)")
    ap.add_argument("--k5-pad", action="store_true",
                    help="time K5's \"im2col_pad\" convs beside the \"im2col32\" route, the "
                    "other tile and cuDNN (no detector)")
    ap.add_argument("--pad-shape", action="append", choices=tuple(K5_PAD_SHAPES),
                    help="--k5-pad's shapes (default: all of K5_PAD_SHAPES)")
    ap.add_argument("--batch", type=int, nargs="+", default=[128],
                    help="--k5's batch sizes; the first is --mode's batch")
    ap.add_argument("--model", default="yolov3",
                    help="--mode's model: a zoo name or a .cfg path")
    ap.add_argument("--size", type=int, default=416, help="--mode's input size")
    ap.add_argument("--shape", action="append", choices=tuple(K5_SHAPES),
                    help="--k5's shapes (default: all of K5_SHAPES)")
    ap.add_argument("--root", default=ROOT, help="the checkout whose port to import")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.ops import kernels

    if args.k5:
        for batch in args.batch:
            print(json.dumps({"root": args.root, "batch": batch,
                              "card": torch.cuda.get_device_name(0),
                              "k5": time_k5(kernels, torch.device("cuda", 0), batch, args.shape,
                                            library=True)}, ensure_ascii=False), flush=True)
        return

    if args.k5_pad:
        print(json.dumps({"root": args.root, "card": torch.cuda.get_device_name(0),
                          "k5_pad": time_k5_pad(kernels, torch.device("cuda", 0),
                                                args.pad_shape)}, ensure_ascii=False),
              flush=True)
        return

    if args.k6:
        print(json.dumps({"root": args.root, "card": torch.cuda.get_device_name(0),
                          **time_k6(kernels, torch.device("cuda", 0))}, ensure_ascii=False),
              flush=True)
        return

    if args.kernels:
        args.mode = "bf16"

    if args.mma:  # every K3/K4 call on the mma.sync core
        for name in ("int8_gemm", "int8_conv"):
            fn = getattr(kernels, name)
            setattr(kernels, name, lambda *a, _fn=fn, **kw: _fn(*a, _mma=True, **kw))
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    kw = {}
    if args.mode == "int8sb":
        calib = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
        kw = dict(quant="w8a8", quant_calib=calib, quant_recipe="none",
                  quant_calib_size=args.size)
    elif args.mode == "int8dyn":
        kw = dict(quant="w8a8")
    det = Detector.load(args.model, device=dev, dtype=torch.bfloat16, precision="default", **kw)
    batch = args.batch[0]
    frames = torch.from_numpy(rng.integers(0, 256, (batch, 480, 640, 3), dtype=np.uint8)).to(dev)

    if args.kernels:
        print(json.dumps(time_kernels(det, frames, kernels, args.root)))
        return

    def step():
        return det.raw_result(frames, size=args.size, conf=0.6, iou=0.45, max_det=300)

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
    total, ops = 0.0, 0
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ops += evt.count
        if not us:
            continue
        if group_of(evt.key) == "other":
            others[evt.key[:90]] += us / 1e3 / args.steps
        g = by_group[group_of(evt.key)]
        g[0] += us / 1e3 / args.steps
        g[1] += evt.count // args.steps
        total += us / 1e3 / args.steps
    card = torch.cuda.get_device_name(0)
    print(f"{args.model}@{args.size} batch {batch} {args.mode}"
          f"{' (mma.sync)' if args.mma else ''} on {card}: median step "
          f"{statistics.median(times):.3f} ms over 10 (min {min(times):.3f}); device time "
          f"{total:.2f} ms per step of a {window / args.steps:.2f} ms profiled step, idle "
          f"{max(0.0, 1 - total / (window / args.steps)):.1%}; {ops / args.steps:.0f} device "
          "operations a step")
    for name, (ms, count) in sorted(by_group.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name:30s} {ms:8.3f} ms  {ms / total:6.1%}  ({count} launches)")
    for name, ms in sorted(others.items(), key=lambda kv: -kv[1])[:6]:
        print(f"    other: {ms:8.3f} ms  {name}")


if __name__ == "__main__":
    main()

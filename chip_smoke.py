#!/usr/bin/env python3
"""Drive the PyTorch port's detection main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one line each (a failure in any phase exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from ``pytorch_yolo_tpu_torch/csrc``;
  3. K1 decode+score against its plain torch version on the card, at the
     yolov3@416 head shapes (batch 8) plus a [region] softmax head and a
     4-anchor new_coords head; the three yolov3 heads in bf16 in one
     launch, equal bit for bit to K1 on their fp32 widening; a misaligned
     head, which must raise; a class tie (the lowest index wins);
  4. K2 NMS keep mask against its plain version, batch 8: K = 300 crowded
     boxes with ties and mixed classes, a chain where each box overlaps
     only its successor (K = 300 and 1024), and crowded boxes at K = 1024
     (masks must be equal);
  5. ``Detector.load("cfg/yolov3.cfg", device="cuda")`` fp32 / "highest"
     against the same detector on the CPU on four 480x640 uint8 frames
     (set agreement must be 1.0), one K1 and one K2 launch;
  6. the serving configuration of ``bench.py``: yolov3@416, bf16, batch 128,
     480x640 uint8 frames already on the device, conf 0.6, iou 0.45,
     max_det 300 — median ms/batch and img/s over 20 timed iterations after
     3 warm-up ones (CUDA events), with the launch counts of that run (one
     K1 and one K2 a step); then, at those shapes, K1 on the step's bf16
     heads against the cast of those heads to fp32 plus K1 on that, in
     turns (cast, bf16, bf16, cast), and K1 on fp32 heads; K2 on the step's
     candidates, on crowded boxes at 128 x 300 and on a 1024-long chain at
     batch 128; each as eager time (``ms``: back-to-back calls between CUDA
     events, host time included, as for K3/K4) and as device time
     (``device_ms``: the same calls replayed from one CUDA graph), beside
     its bound and its plain version; and the fixpoint's round counts;
  7. K3 (int8 GEMM) in the int8 probe's fixed-point mode at its two shapes,
     and K3/K4 (int8 implicit-GEMM conv) with the serving epilogue at four
     yolov3 conv shapes (batch 8), each epilogue mode once, plus edge cases
     of the wgmma core (ragged M with more tiles than SMs, O = 1024 and 16,
     split groups that are not multiples of 128 channels, a ragged stride-2
     output, int8 out with O not a multiple of 16, the byte path), each on
     the core ``igemm_plan`` picks (its launch counter checked) and on the
     ``mma.sync`` core, against their plain versions (int32 and int8 equal,
     fp32 within 1e-6 relative);
  8. yolov3-tiny@416 ``quant="w8a8"`` with fp32 glue (every non-head conv
     int8, the maxpool ladder int8-resident), static scales calibrated on
     the card from 4 frames (``quant_recipe="none"``), against the CPU
     serving the card's ``quant_state()`` (set agreement >= 0.995), one K1
     and one K2 launch;
  9. the int8 slice at full width, ``bench.py``'s ``int8sb``: yolov3@416
     w8a8 with bf16 glue, the stride-8 early skip, int8-resident chains,
     static scales from 4 frames, batch 128, the frames of phase 6 — median
     ms/batch and img/s as in phase 6, the launch counts (one K1 and one K2
     a step, one K3/K4 launch a quantized conv), the drift against
     phase 6's bf16 detections (printed, not gated); it fails if any of its
     int8 convs ran on the ``mma.sync`` core.  Then K3's and K4's times at
     phase 7's four yolov3 shapes at batch 128: the wgmma core and the
     ``mma.sync`` core in turns (old, new, new, old), the wgmma core's
     device time, the plain version, a cuDNN bf16 ``F.conv2d`` of the same
     shape, ``torch._int_mm`` for K3, and the bound (ops at 1,979 TOPS or
     bytes at 3.35 TB/s, whichever is longer) with the share of it each
     core reaches;
 10. live weights: ``Detector.load("cfg/yolov3.cfg", synthetic="live")`` on
     the card at fp32 / "highest" (the LSUV equalizer runs there; its sweeps
     and largest |log std| printed), the same weights served on the CPU on
     2 frames (set agreement must be 1.0), one K1 and one K2 launch;
 11. drift on the card, the JAX package's ``bench.measure_drift`` table:
     yolov3@416 live weights, 4 eval frames (seed 0), 4 held-out
     calibration frames (seeds 100-103), each mode against the fp32
     reference: bf16 with the s2d stem and without, int8 dynamic, int8
     static (``quant_recipe="none"``), int8sb "none" and int8sb "auto" (the
     recipe: percentile ranging, smoothing, bias correction; its K3/K4
     calibration launches and the K1/K2 serving launches checked).  Fails
     on a degenerate row, or if "auto" does not beat "none" on int8sb;
     then yolov3-tiny@416 live, "auto" calibrated on the card, against the
     CPU serving the card's ``quant_state()`` (>= 0.995);
 12. A/B at batch 128 on the live weights, phase 6's method: bf16 with the
     s2d stem off, on, on, off, and the two stems' layers timed alone;
     int8sb "none", "auto", "auto", "none"; and K2 eager and device ms on
     the live step's candidates, with its bound and the fixpoint's rounds,
     beside phase 6's.

The line before the second-to-last is the kernels' JSON report (``ms``
eager time, as every kernel's figure since the port began; ``device_ms``
the CUDA-graph device time of the same calls); the
second-to-last is the card as nvidia-smi names it; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or run outside the
repository, the script exits non-zero and prints no result.
Synthetic He-init weights (seed 0) in phases 3-9, live (equalized) ones
in 10-12; frames from numpy seed 0.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BATCH = 128
SIZE = 416
CONF, IOU, MAX_DET = 0.6, 0.45, 300
TOL = 1e-5  # K1: expf and summation order; box columns relative to the row's corners
# H100 SXM published dense peaks (NVIDIA data sheet, 700 W): the bounds' rates.
PEAK_INT8_OPS = 1.979e15
PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def abs_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b|, with equal values (saturated heads give infinite boxes) and
    NaN pairs counted as 0."""
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    return (a - b).abs().masked_fill(same, 0.0)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(abs_diff(a, b).max())


def rows_close(ours: torch.Tensor, ref: torch.Tensor) -> bool:
    """K1 rows: boxes within TOL of the row's largest finite corner,
    obj/score/rank within TOL, class ids exact."""
    corners = ref[..., :4].abs()
    scale = corners.masked_fill(~torch.isfinite(corners), 0.0).amax(-1, keepdim=True)
    boxes_ok = bool((abs_diff(ours[..., :4], ref[..., :4]) <= TOL + TOL * scale).all())
    rest_ok = bool((abs_diff(ours[..., [4, 5, 7]], ref[..., [4, 5, 7]])
                    <= TOL + TOL * ref[..., [4, 5, 7]].abs()).all())
    return boxes_ok and rest_ok and torch.equal(ours[..., 6], ref[..., 6])


def int8_case(rng, k, stride, shape, o, mode, device):
    """Inputs of one K3/K4 check: (xq, wq, stride, pad, epilogue kwargs).
    ``mode``: "acc", "fixed", or a dict with "sx" ("dynamic", "static",
    "int8" input, "vector" grid) or "splits", "act", and "out" ("scalar" /
    "vector" requant)."""
    from pytorch_yolo_tpu_torch.ops.quant import dynamic_scale, quantize_input

    c = shape[-1]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt).to(device)  # noqa: E731
    wq = t(rng.integers(-127, 128, (o, k, k, c)), torch.int8)
    if mode == "acc":
        return t(rng.integers(-127, 128, shape), torch.int8), wq, stride, k // 2, {
            "accumulators": True}
    if mode == "fixed":
        return t(rng.integers(-127, 128, shape), torch.int8), wq, stride, 0, {
            "fixed": (10, 181, 8)}
    kw = {"activation": mode["act"], "b": t(rng.normal(0.0, 0.5, o))}
    sx_val = 1.0
    if "splits" in mode:
        xf = torch.randn(shape, generator=torch.Generator(device).manual_seed(1), device=device)
        sxg = t(rng.uniform(0.02, 0.04, len(mode["splits"])))
        parts, off = [], 0
        for g, cg in enumerate(mode["splits"]):
            parts.append(quantize_input(xf[..., off:off + cg], sxg[g]))
            off += cg
        xq, sx_val = torch.cat(parts, -1), 0.03
        kw.update(sxg=sxg, splits=mode["splits"])
    elif mode["sx"] == "int8":
        xq, sx = t(rng.integers(-127, 128, shape), torch.int8), t(0.025)
        kw["sx"], sx_val = sx, 0.025
    else:
        xf = torch.randn(shape, generator=torch.Generator(device).manual_seed(2), device=device)
        sx = {"dynamic": lambda: dynamic_scale(xf),
              "static": lambda: t(0.025),
              "vector": lambda: t(rng.uniform(0.01, 0.04, c))}[mode["sx"]]()
        xq = quantize_input(xf, sx)
        sx_val = 1.0 if sx.dim() == 1 else float(sx)
        kw["sx"] = sx
    acc_std = np.sqrt(k * k * c) * 35.0 * 73.0
    kw["ws"] = t(rng.uniform(0.5, 1.5, o) * 1.5 / acc_std / sx_val)
    if "out" in mode:
        kw["out_scale"] = t(0.012) if mode["out"] == "scalar" else t(rng.uniform(0.008, 0.016, o))
    return xq, wq, stride, k // 2, kw


def run_int8(kernels, xq, wq, stride, pad, kw, plain=False, mma=False):
    """K3 for a 1x1 stride-1 weight, K4 otherwise (or their plain versions;
    ``mma`` forces the ``mma.sync`` core)."""
    core = {} if plain else {"_mma": mma}
    if wq.shape[1] == 1 and stride == 1:
        n, h, w, c = xq.shape
        fn = kernels.gemm_i8_ref if plain else kernels.int8_gemm
        return fn(xq.reshape(-1, c), wq.reshape(wq.shape[0], c), **core, **kw).reshape(
            n, h, w, -1)
    fn = kernels.int8_conv_ref if plain else kernels.int8_conv
    return fn(xq, wq, stride, pad, **core, **kw)


def int8_key(kernels, wq, stride, kw) -> str:
    """The LAUNCHES key of the core ``igemm_plan`` picks for a K3/K4 call."""
    name = "int8_gemm" if wq.shape[1] == 1 and stride == 1 else "int8_conv"
    c = wq.shape[-1]
    goff = [0, c]
    if "splits" in kw:
        goff = [0]
        for g in kw["splits"]:
            goff.append(goff[-1] + g)
    core, _ = kernels.igemm_plan(c, goff, wq.shape[0], "splits" in kw, True)
    return name if core == "wgmma" else name + "_mma"


def bound(ops: float, nbytes: float, peak_ops: float) -> tuple[float, str]:
    """The least time in ms the card could take, and what sets it."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, warmup: int = 1) -> float:
    """Mean device ms per call of ``iters`` calls captured in one CUDA graph
    and replayed (device time only: no host time between launches).  The
    capture is relaxed: a launcher may set a kernel attribute."""
    for _ in range(warmup):
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
    del g
    return start.elapsed_time(end) / iters


def in_turns(plain, kernel, plain_iters: int = 20, timer=time_ms) -> tuple[float, float]:
    """Plain, kernel, kernel, plain; the mean of each pair (one card, one call)."""
    p1 = timer(plain, plain_iters, min(3, plain_iters))
    k1, k2 = timer(kernel), timer(kernel)
    p2 = timer(plain, plain_iters, min(3, plain_iters))
    return (k1 + k2) / 2, (p1 + p2) / 2


def pipeline_ms(step) -> tuple[list[float], object]:
    """20 timed calls of ``step`` after 3 warm-up ones, each between CUDA
    events; returns the times and the last result."""
    for _ in range(3):
        step()
    times = []
    for _ in range(20):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = step()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times, res


def check_result(res, what: str) -> None:
    if tuple(res.boxes.shape) != (BATCH, MAX_DET, 4) or not bool(res.valid.any()):
        fail(f"{what} result has shape {tuple(res.boxes.shape)} and "
             f"{int(res.valid.sum())} valid rows")
    if not bool(torch.isfinite(res.boxes[res.valid]).all()):
        fail(f"{what} result has non-finite kept boxes")


def crowded_boxes(rng, n: int, k: int, device):
    """Score-ordered candidates in overlapping clusters, 10% exact duplicates
    of the row above, ~15% invalid rows, classes 0..3."""
    centers = rng.uniform(40, 376, size=(n, k // 12, 2))
    pick = rng.integers(0, centers.shape[1], size=(n, k))
    cxy = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 8, (n, k, 2))
    wh = rng.uniform(10, 90, size=(n, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    dup = rng.uniform(size=(n, k)) < 0.1
    boxes[:, 1:][dup[:, 1:]] = boxes[:, :-1][dup[:, 1:]]
    valid = rng.uniform(size=(n, k)) > 0.15
    cls = rng.integers(0, 4, size=(n, k)).astype(np.float32)
    return (torch.from_numpy(boxes).to(device), torch.from_numpy(valid).to(device),
            torch.from_numpy(cls).to(device))


def plain_rows(kernels, heads, spec) -> torch.Tensor:
    """K1's plain torch version over every head, on the heads' device."""
    return torch.cat([kernels.decode_score_head_ref(raw, p.anchors, p.stride, p.classes,
                                                    cls_act=p.cls_act, scale_xy=p.scale_xy,
                                                    new_coords=p.new_coords)
                      for raw, p in zip(heads, kernels.decode_plan(heads, spec))], dim=1)


def chain_boxes(n: int, k: int, device):
    """K boxes in a row, box i = [i, 0, i+3, 10]: IoU 0.5 with its successor,
    0.2 with the one after, so greedy NMS keeps every other box and the
    parallel fixpoint needs K rounds.  All valid, one class."""
    x = torch.arange(k, dtype=torch.float32, device=device)
    row = torch.stack([x, torch.zeros_like(x), x + 3, torch.full_like(x, 10.0)], -1)
    return (row.expand(n, k, 4).contiguous(), torch.ones((n, k), dtype=torch.bool, device=device),
            torch.zeros((n, k), device=device))


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pytorch_yolo_tpu_torch", "csrc")):
        fail(f"no pytorch_yolo_tpu_torch/ beside {__file__}: run it from a checkout")
    sys.path.insert(0, root)  # the checkout's package, not an installed one
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.config import head_strides, load_model_spec
    from pytorch_yolo_tpu_torch.ops import kernels
    from pytorch_yolo_tpu_torch.ops.decode import head_decode_args
    from pytorch_yolo_tpu_torch.ops.nms import fixpoint_rounds, iou_matrix
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch
    from pytorch_yolo_tpu_torch.utils.drift import detection_drift

    cfg = os.path.join(root, "cfg", "yolov3.cfg")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    # 1. the card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1 card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| {kind} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.load_library()
    say(f"phase 2 build: {time.perf_counter() - t0:.2f} s ({kernels.LIBRARY})")

    # 3. K1 against its plain version
    v3 = load_model_spec(cfg)
    heads_v3 = [(f"yolov3 {SIZE // s}x{SIZE // s}", (8, SIZE // s, SIZE // s, 255), h, s, False)
                for h, s in zip(v3.yolo_layers, head_strides(v3))]
    v2 = load_model_spec(os.path.join(root, "cfg", "yolov2.cfg"))
    p5 = load_model_spec(os.path.join(root, "cfg", "yolov4-p5.cfg"))
    extra = [("yolov2 region softmax 13x13", (8, 13, 13, 425), v2.yolo_layers[0],
              head_strides(v2)[0], False),
             ("yolov4-p5 4-anchor new_coords 52x52", (8, 52, 52, 340), p5.yolo_layers[0],
              head_strides(p5)[0], True)]
    k1_err = 0.0
    for name, shape, head, stride, pre in heads_v3 + extra:
        anchors, cls_act, sxy, nc = head_decode_args(head, stride)
        x = rng.uniform(0, 1, shape) if pre else rng.normal(0, 2, shape)
        raw = torch.from_numpy(x.astype(np.float32)).to(dev)
        kw = dict(cls_act=cls_act, scale_xy=sxy, new_coords=nc)
        ours = kernels.decode_score_head(raw, anchors, stride, head.classes, **kw)
        ref = kernels.decode_score_head_ref(raw, anchors, stride, head.classes, **kw)
        torch.cuda.synchronize()
        err = max_err(ours, ref)
        if not rows_close(ours, ref):
            fail(f"K1 {name}: kernel disagrees with its plain version (max abs err {err})")
        if head in v3.yolo_layers:
            k1_err = max(k1_err, err)
        say(f"phase 3 K1 {name} {tuple(shape)}: ok, max abs err {err:.3g} "
            f"(tol {TOL} rel. to row corners; cls_id exact)")
    heads_bf16 = tuple(torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32))
                       .to(torch.bfloat16).to(dev) for _, shape, _, _, _ in heads_v3)
    before = dict(kernels.LAUNCHES)
    ours = kernels.decode_score_all(heads_bf16, v3)
    torch.cuda.synchronize()
    if kernels.LAUNCHES != {**before, "decode_score": before["decode_score"] + 1}:
        fail(f"K1 on three bf16 heads: expected one launch, counts {kernels.LAUNCHES}")
    wide = tuple(h.to(torch.float32) for h in heads_bf16)
    ref = plain_rows(kernels, heads_bf16, v3)
    err = max_err(ours, ref)
    k1_err = max(k1_err, err)
    if not rows_close(ours, ref):
        fail(f"K1 bf16 yolov3 heads: kernel disagrees with its plain version ({err})")
    if not torch.equal(ours, kernels.decode_score_all(wide, v3)):
        fail("K1 bf16 yolov3 heads: rows differ from K1's on their fp32 widening")
    say(f"phase 3 K1 yolov3 bf16 heads, batch 8, one launch: ok, max abs err {err:.3g}, equal "
        "to K1 on the fp32 widening")
    odd = torch.zeros(heads_bf16[0].numel() + 1, dtype=torch.bfloat16, device=dev)
    try:
        kernels.decode_score_head(odd[1:].view(heads_bf16[0].shape), v3.yolo_layers[0].anchors,
                                  32, 80)
        fail("K1 took a head that is not 16-byte aligned")
    except ValueError as e:
        say(f"phase 3 K1 misaligned head: raised ({e})")
    ties = torch.zeros((2, 13, 13, 3 * 85), device=dev)
    ties[..., [5 + 2, 85 + 5 + 2, 170 + 5 + 2]] = 3.0
    ties[..., [5 + 4, 85 + 5 + 4, 170 + 5 + 4]] = 3.0
    tied = kernels.decode_score_head(ties, v3.yolo_layers[0].anchors, 32, 80)
    if not bool((tied[..., 6] == 2).all()):
        fail("K1 class tie: the lowest class index must win")
    say("phase 3 K1 class tie: ok (lowest index wins)")

    # 4. K2 against its plain version
    k2_err = 0.0
    for case, k in (("crowded", MAX_DET), ("chain", MAX_DET), ("chain", 1024), ("crowded", 1024)):
        for class_wise in (True, False):
            boxes, valid, cls = (crowded_boxes(rng, 8, k, dev) if case == "crowded"
                                 else chain_boxes(8, k, dev))
            c = cls if class_wise else None
            ours = kernels.nms_keep(boxes, valid, IOU, c)
            ref = kernels.nms_keep_ref(boxes, valid, IOU, c)
            torch.cuda.synchronize()
            diff = int((ours != ref).sum())
            k2_err = max(k2_err, float(diff))
            if diff:
                fail(f"K2 {case} K={k} class_wise={class_wise}: {diff} keep entries differ from "
                     "the plain version")
            say(f"phase 4 K2 {case} K={k} batch 8 class_wise={class_wise}: ok, keep mask equal "
                f"to the plain version's ({int(ours.sum())} kept of {int(valid.sum())} valid)")

    # 5. the slice at fp32 on the card against the CPU
    frames4 = rng.integers(0, 256, size=(4, 480, 640, 3), dtype=np.uint8)
    det_gpu = Detector.load(cfg, device=dev, precision="highest")
    det_cpu = Detector.load(cfg, device="cpu", precision="highest")
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    gpu = det_gpu.detect_batch(frames4, size=SIZE, conf=CONF, iou=IOU, max_det=MAX_DET)
    torch.cuda.synchronize()
    launches5 = dict(kernels.LAUNCHES)
    if not (launches5["decode_score"] == 1 and launches5["nms_keep"] == 1):
        fail(f"fp32 detect_batch on the card: expected one K1 and one K2 launch: {launches5}")
    cpu = det_cpu.detect_batch(frames4, size=SIZE, conf=CONF, iou=IOU, max_det=MAX_DET)
    stats = detection_drift(cpu, gpu)
    if not (stats.ref_dets > 0 and stats.set_agreement == 1.0):
        fail(f"fp32 card vs CPU: {stats.row()}")
    if not all(np.isfinite(d.boxes).all() and d.boxes.shape[1:] == (4,) for d in gpu):
        fail("fp32 detections are not finite (M, 4) boxes")
    say(f"phase 5 yolov3@{SIZE} fp32 highest, 4 frames, card vs CPU: {stats.row()}; "
        f"launches {launches5}")

    # 6. bench serving configuration: bf16, batch 128, frames on the device
    del det_gpu, det_cpu
    det = Detector.load(cfg, device=dev, dtype=torch.bfloat16, precision="default")
    frames = torch.from_numpy(rng.integers(0, 256, size=(BATCH, 480, 640, 3),
                                           dtype=np.uint8)).to(dev)

    def step():
        return det.raw_result(frames, size=SIZE, conf=CONF, iou=IOU, max_det=MAX_DET)

    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    times, res = pipeline_ms(step)
    launches = dict(kernels.LAUNCHES)
    steps = len(times) + 3  # 3 warm-up steps
    if not (launches["decode_score"] == steps and launches["nms_keep"] == steps):
        fail(f"the bf16 main path: expected one K1 and one K2 launch in each of {steps} steps: "
             f"{launches}")
    check_result(res, "bf16")
    bf16_dets = det._trim(res, BATCH)
    ms = statistics.median(times)
    say(f"phase 6 yolov3@{SIZE} bf16 batch {BATCH} pipeline: median {ms:.3f} ms/batch, "
        f"{BATCH / ms * 1e3:.1f} img/s (min {min(times):.3f}, max {max(times):.3f} ms; "
        f"{int(res.valid.sum())} kept) on {card}; launches {launches}")

    # kernel times at the main path's shapes, beside the plain versions and
    # the bounds: eager (``ms``, as K3/K4) and device time (``device_ms``)
    with torch.no_grad():
        heads = det.model(letterbox_batch(frames, SIZE), _native_heads=True)  # as served
    spec = det.spec
    if any(h.dtype != torch.bfloat16 for h in heads):
        fail(f"the bf16 pipeline's heads are {[h.dtype for h in heads]}, not bf16")
    heads32 = tuple(h.to(torch.float32).contiguous() for h in heads)

    def k1():  # the main path: the head convs' bf16 output, one launch
        return kernels.decode_score_all(heads, spec)

    def cast():  # what K1 read before it took bf16: the heads cast to fp32
        return tuple(h.to(torch.float32).contiguous() for h in heads)

    def k1_cast():
        return kernels.decode_score_all(cast(), spec)

    rows = k1()
    k1_plain_rows = plain_rows(kernels, heads, spec)
    k1_main_err = max_err(rows, k1_plain_rows)
    if not rows_close(rows, k1_plain_rows):
        fail(f"K1 on the main path's heads disagrees with its plain version ({k1_main_err})")
    if not torch.equal(rows, kernels.decode_score_all(heads32, spec)):
        fail("K1 on the main path's bf16 heads differs from K1 on their fp32 widening")
    del k1_plain_rows
    masked = torch.where(rows[..., 4] > CONF, rows[..., 7], torch.full_like(rows[..., 7], -1.0))
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    sel = torch.gather(rows, 1, idx[:, :MAX_DET, None].expand(BATCH, MAX_DET, 8))
    boxes, cls_f = sel[..., :4].contiguous(), sel[..., 6].contiguous()
    valid = (top[:, :MAX_DET] > 0).contiguous()
    if not torch.equal(kernels.nms_keep(boxes, valid, IOU, cls_f),
                       kernels.nms_keep_ref(boxes, valid, IOU, cls_f)):
        fail("K2 on the main path's candidates disagrees with its plain version")
    crowd = crowded_boxes(rng, BATCH, MAX_DET, dev)
    if not torch.equal(kernels.nms_keep(crowd[0], crowd[1], IOU, crowd[2]),
                       kernels.nms_keep_ref(crowd[0], crowd[1], IOU, crowd[2])):
        fail(f"K2 on crowded boxes at {BATCH}x{MAX_DET} disagrees with its plain version")
    over = iou_matrix(boxes) > IOU
    over &= (cls_f[:, :, None] - cls_f[:, None, :]).abs() < 0.5
    rounds = fixpoint_rounds(over, valid)
    over = iou_matrix(crowd[0]) > IOU
    over &= (crowd[2][:, :, None] - crowd[2][:, None, :]).abs() < 0.5
    crowd_rounds = fixpoint_rounds(over, crowd[1])
    chain = chain_boxes(BATCH, 1024, dev)
    chain_rounds = fixpoint_rounds(iou_matrix(chain[0][:2]) > IOU, chain[1][:2])
    every_other = (torch.arange(1024, device=dev) % 2 == 0).expand(BATCH, 1024)
    if not torch.equal(kernels.nms_keep(*chain[:2], IOU), every_other):
        fail("K2 on the 1024-long chain at batch 128 does not keep every other box")
    del over

    k1_ms, k1_cast_ms = in_turns(k1_cast, k1)
    k1_dev_ms, k1_cast_dev_ms = in_turns(k1_cast, k1, timer=graph_ms)
    k1_32 = lambda: kernels.decode_score_all(heads32, spec)  # noqa: E731
    k1_32_ms, k1_32_dev_ms = time_ms(k1_32), graph_ms(k1_32)
    cast_ms = graph_ms(cast)
    k1_plain_ms = time_ms(lambda: plain_rows(kernels, heads, spec), 5, 1)
    k2 = lambda: kernels.nms_keep(boxes, valid, IOU, cls_f)  # noqa: E731
    k2_ms, k2_dev_ms = time_ms(k2), graph_ms(k2)
    k2_plain_ms = time_ms(lambda: kernels.nms_keep_ref(boxes, valid, IOU, cls_f))
    k2_crowd = lambda: kernels.nms_keep(crowd[0], crowd[1], IOU, crowd[2])  # noqa: E731
    k2_crowd_ms, k2_crowd_dev_ms = time_ms(k2_crowd), graph_ms(k2_crowd)
    k2_crowd_plain_ms = time_ms(lambda: kernels.nms_keep_ref(crowd[0], crowd[1], IOU, crowd[2]))
    # where K2's time goes: no candidate valid (no IoU, nothing to decide:
    # launch, loads, barriers, the scan's loads, the stores) and class-agnostic
    none = torch.zeros_like(valid)
    k2_floor_ms = graph_ms(lambda: kernels.nms_keep(boxes, none, IOU, cls_f))
    k2_agnostic_ms = graph_ms(lambda: kernels.nms_keep(boxes, valid, IOU))
    k2_chain = lambda: kernels.nms_keep(*chain[:2], IOU)  # noqa: E731
    k2_chain_ms, k2_chain_dev_ms = time_ms(k2_chain), graph_ms(k2_chain)
    # K1 reads each head once and writes the rows once; ~2 fp32 ops per class
    # (max, argmax) and ~40 per row (activations, box) are far below that.
    out_bytes = rows.numel() * 4
    k1_ops = rows.shape[0] * rows.shape[1] * (2 * spec.yolo_layers[0].classes + 40)
    k1_bound, k1_by = bound(k1_ops, sum(h.numel() * 2 for h in heads) + out_bytes, PEAK_FP32_OPS)
    k1_32_bound, _ = bound(k1_ops, sum(h.numel() * 4 for h in heads) + out_bytes, PEAK_FP32_OPS)
    cast_bound, _ = bound(0, sum(h.numel() * 6 for h in heads), PEAK_FP32_OPS)

    def k2_bound_of(valid_mask, class_ids: bool) -> tuple[float, str]:
        """K2 reads boxes, valid (and class ids) and writes the mask once; the
        relation needs ~15 fp32 ops for each pair j < i of valid candidates
        (the suppression reuses it)."""
        v = valid_mask.sum(1).double()
        n, k = valid_mask.shape
        return bound(15 * float((v * (v - 1) / 2).sum()),
                     n * k * (16 + 1 + 1 + (4 if class_ids else 0)), PEAK_FP32_OPS)

    k2_bound, k2_by = k2_bound_of(valid, True)
    k2_crowd_bound, _ = k2_bound_of(crowd[1], True)
    k2_chain_bound, _ = k2_bound_of(chain[1], False)
    say(f"phase 6 K1 decode_score_all, 3 bf16 heads, batch {BATCH}, one launch: {k1_ms:.4f} ms "
        f"eager, {k1_dev_ms:.4f} ms device ({k1_bound / k1_dev_ms:.1%} of its {k1_bound:.4f} ms "
        f"bound, {k1_by}); the same heads cast to fp32 + K1: {k1_cast_ms:.4f} ms eager, "
        f"{k1_cast_dev_ms:.4f} ms device (the cast alone {cast_ms:.4f} ms device, bound "
        f"{cast_bound:.4f}); plain {k1_plain_ms:.4f} ms; on {card}")
    say(f"phase 6 K1 on fp32 heads: {k1_32_ms:.4f} ms eager, {k1_32_dev_ms:.4f} ms device "
        f"({k1_32_bound / k1_32_dev_ms:.1%} of {k1_32_bound:.4f} ms)")
    say(f"phase 6 K2 nms_keep {BATCH}x{MAX_DET} on the step's candidates ({int(valid.sum())} valid, "
        f"fixpoint rounds {rounds}): {k2_ms:.4f} ms eager, {k2_dev_ms:.4f} ms device "
        f"({k2_bound / k2_dev_ms:.1%} of {k2_bound:.5f} ms, {k2_by}); plain {k2_plain_ms:.4f} ms; "
        f"the same boxes with no candidate valid {k2_floor_ms:.4f} ms device, class-agnostic "
        f"{k2_agnostic_ms:.4f} ms device")
    say(f"phase 6 K2 nms_keep {BATCH}x{MAX_DET} on crowded boxes ({int(crowd[1].sum())} valid, "
        f"4 classes, fixpoint rounds {crowd_rounds}): {k2_crowd_ms:.4f} ms eager, "
        f"{k2_crowd_dev_ms:.4f} ms device ({k2_crowd_bound / k2_crowd_dev_ms:.1%} of "
        f"{k2_crowd_bound:.5f} ms); plain {k2_crowd_plain_ms:.4f} ms; 1024-long chain at batch "
        f"{BATCH} (fixpoint rounds {chain_rounds}): {k2_chain_ms:.4f} ms eager, "
        f"{k2_chain_dev_ms:.4f} ms device ({k2_chain_bound / k2_chain_dev_ms:.1%} of "
        f"{k2_chain_bound:.5f} ms)")
    del det, heads, heads32, rows, chain, crowd

    # 7. K3 and K4 against their plain versions
    errs = {"int8_gemm": 0.0, "int8_conv": 0.0}
    probe = [("probe (4096,1024)x(1024,512)", 1, 1, (1, 1, 4096, 1024), 512, "fixed"),
             ("probe (32768,256)x(256,128)", 1, 1, (1, 1, 32768, 256), 128, "fixed")]
    v3_shapes = {"1x1 52² 256->128": (1, 1, (8, 52, 52, 256), 128),
                 "3x3 s1 52² 128->256": (3, 1, (8, 52, 52, 128), 256),
                 "3x3 s2 104²->52² 128->256": (3, 2, (8, 104, 104, 128), 256),
                 "3x3 s1 13² 512->1024": (3, 1, (8, 13, 13, 512), 1024)}
    modes = {"1x1 52² 256->128": ["acc", {"sx": "dynamic", "act": "leaky"},
                                  {"splits": (128, 128), "act": "leaky"},
                                  {"sx": "static", "act": "leaky", "out": "vector"}],
             "3x3 s1 52² 128->256": ["acc", {"sx": "static", "act": "mish"},
                                     {"sx": "int8", "act": "leaky", "out": "scalar"}],
             "3x3 s2 104²->52² 128->256": ["acc", {"sx": "vector", "act": "leaky"}],
             "3x3 s1 13² 512->1024": ["acc", {"sx": "static", "act": "leaky"},
                                      {"splits": (256, 128, 128), "act": "mish",
                                       "out": "vector"}]}
    edge = [("ragged M, tiles > SMs", 1, 1, (2, 97, 89, 64), 128, "acc"),
            ("conv ragged M, tiles > SMs", 3, 1, (2, 100, 93, 32), 64,
             {"sx": "static", "act": "leaky"}),
            ("O=1024 (BN 256)", 1, 1, (1, 13, 13, 512), 1024, {"sx": "static", "act": "leaky"}),
            ("O=16", 1, 1, (1, 20, 20, 64), 16, {"sx": "static", "act": "mish"}),
            ("split (80, 176)", 1, 1, (2, 26, 26, 256), 128, {"splits": (80, 176), "act": "leaky"}),
            ("split (48, 96, 112) int8 out O=72", 1, 1, (1, 26, 26, 256), 72,
             {"splits": (48, 96, 112), "act": "leaky", "out": "vector"}),
            ("s2 ragged O=72", 3, 2, (1, 27, 33, 48), 72, {"sx": "static", "act": "leaky"}),
            ("int8 out O=40", 3, 1, (1, 13, 13, 64), 40, {"sx": "static", "act": "leaky",
                                                          "out": "scalar"}),
            ("byte path C=3", 3, 1, (2, 32, 32, 3), 16, "acc"),
            ("byte path K=24", 1, 1, (1, 16, 16, 24), 32, {"sx": "static", "act": "leaky"})]
    cases = probe + [(f"{name} {m if isinstance(m, str) else m}", *v3_shapes[name], m)
                     for name in v3_shapes for m in modes[name]] + edge
    cores = {"wgmma": 0, "mma": 0}
    for name, k, stride, shape, o, mode in cases:
        xq, wq, st, pad, kw = int8_case(rng, k, stride, shape, o, mode, dev)
        ref = run_int8(kernels, xq, wq, st, pad, kw, plain=True)
        want = int8_key(kernels, wq, st, kw)
        for mma in (False, True):
            key = want if not mma else want.removesuffix("_mma") + "_mma"
            before = kernels.LAUNCHES[key]
            ours = run_int8(kernels, xq, wq, st, pad, kw, mma=mma)
            torch.cuda.synchronize()
            if kernels.LAUNCHES[key] != before + 1:
                fail(f"{name}: expected one launch of {key}, counts {kernels.LAUNCHES}")
            if ours.dtype != ref.dtype or ours.shape != ref.shape:
                fail(f"{key} {name}: {ours.dtype} {tuple(ours.shape)} vs plain {ref.dtype} "
                     f"{tuple(ref.shape)}")
            if ref.dtype == torch.float32:
                err = max_err(ours, ref)
                rel = float((abs_diff(ours, ref) / ref.abs().clamp_min(1e-30)).max())
                ok = bool((abs_diff(ours, ref) <= 1e-6 * ref.abs()).all())
                what = f"max abs err {err:.3g}, max rel err {rel:.3g} (tol 1e-6 rel.)"
            else:
                err = float((ours.long() - ref.long()).abs().max())
                ok, what = err == 0, f"{ref.dtype} equal"
            base_key = key.removesuffix("_mma")
            errs[base_key] = max(errs[base_key], err)
            cores["mma" if key.endswith("_mma") else "wgmma"] += 1
            if not ok:
                fail(f"{key} {name}: kernel disagrees with its plain version ({what}, {err})")
            say(f"phase 7 {key} {name} {tuple(shape)}->{o}: ok, {what}")
    say(f"phase 7: {len(cases)} cases, {cores['wgmma']} on the wgmma core and {cores['mma']} "
        f"on the mma.sync core, all equal to the plain versions")

    # 8. int8 yolov3-tiny at fp32 glue: card against CPU.  Not 1.0: the fp32
    # head convs run in cuDNN on the card and in oneDNN on the CPU, and an
    # ulp of difference before a requant can move an int8 value by one step.
    tiny = os.path.join(root, "cfg", "yolov3-tiny.cfg")
    calib = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
    det_gpu = Detector.load(tiny, device=dev, quant="w8a8", quant_calib=calib,
                            quant_recipe="none")
    state = det_gpu.quant_state()
    det_cpu = Detector.load(tiny, device="cpu", quant="w8a8", quant_act_scales=state["scales"],
                            quant_skip_layers=frozenset(state["skip"]))
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    gpu = det_gpu.detect_batch(frames4, size=SIZE, conf=0.5, iou=IOU, max_det=MAX_DET)
    torch.cuda.synchronize()
    launches8 = dict(kernels.LAUNCHES)
    if not all(launches8[k] for k in ("int8_gemm", "int8_conv")):
        fail(f"int8 detect_batch on the card bypassed a kernel: {launches8}")
    if not (launches8["decode_score"] == 1 and launches8["nms_keep"] == 1):
        fail(f"int8 detect_batch: expected one K1 and one K2 launch: {launches8}")
    cpu = det_cpu.detect_batch(frames4, size=SIZE, conf=0.5, iou=IOU, max_det=MAX_DET)
    stats8 = detection_drift(cpu, gpu)
    if not (stats8.ref_dets > 0 and stats8.set_agreement >= 0.995):
        fail(f"int8 yolov3-tiny card vs CPU: {stats8.row()}")
    if not all(np.isfinite(d.boxes).all() and d.boxes.shape[1:] == (4,) for d in gpu):
        fail("int8 detections are not finite (M, 4) boxes")
    say(f"phase 8 yolov3-tiny@{SIZE} w8a8 fp32 glue, static scales from 4 frames, card vs CPU: "
        f"set agreement {stats8.set_agreement:.4f} (>= 0.995); {stats8.row()}; "
        f"{len(det_gpu.model.qconvs)} int8 convs, chains {det_gpu.model._chains}; "
        f"launches {launches8}")
    del det_gpu, det_cpu

    # 9. int8sb at full width: yolov3@416, w8a8, bf16 glue, batch 128
    t0 = time.perf_counter()
    det = Detector.load(cfg, device=dev, dtype=torch.bfloat16, precision="default",
                        quant="w8a8", quant_calib=calib, quant_recipe="none")
    build_s = time.perf_counter() - t0

    def step9():
        return det.raw_result(frames, size=SIZE, conf=CONF, iou=IOU, max_det=MAX_DET)

    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    times9, res9 = pipeline_ms(step9)
    launches9 = dict(kernels.LAUNCHES)
    if not all(launches9[k] for k in ("int8_gemm", "int8_conv")):
        fail(f"the int8sb path bypassed a kernel: {launches9}")
    if not (launches9["decode_score"] == steps and launches9["nms_keep"] == steps):
        fail(f"the int8sb path: expected one K1 and one K2 launch in each of {steps} steps: "
             f"{launches9}")
    if launches9["int8_gemm_mma"] or launches9["int8_conv_mma"]:
        fail(f"an int8sb conv ran on the mma.sync core: {launches9}")
    n_int8 = launches9["int8_gemm"] + launches9["int8_conv"]
    if n_int8 != len(det.model.qconvs) * (len(times9) + 3):  # 3 warm-up steps
        fail(f"int8sb launched {n_int8} int8 convs in {len(times9) + 3} steps of "
             f"{len(det.model.qconvs)}")
    check_result(res9, "int8sb")
    drift9 = detection_drift(bf16_dets, det._trim(res9, BATCH))
    ms9 = statistics.median(times9)
    say(f"phase 9 yolov3@{SIZE} int8sb (w8a8, bf16 glue, early skip stride 8, "
        f"{len(det.model.qconvs)} int8 convs, {len(det.model._chains)} int8-resident links) "
        f"batch {BATCH} pipeline: median {ms9:.3f} ms/batch, {BATCH / ms9 * 1e3:.1f} img/s "
        f"(min {min(times9):.3f}, max {max(times9):.3f} ms; {int(res9.valid.sum())} kept; "
        f"load+calibrate {build_s:.1f} s) on {card}; bf16 phase 6: {ms:.3f} ms/batch; "
        f"launches {launches9}")
    say(f"phase 9 drift int8sb vs bf16 (He-init weights saturate: not gated): {drift9.row()}")
    del det, res9

    # K3 and K4 at batch 128: the wgmma core against the mma.sync core in
    # turns, beside the plain version, cuDNN bf16, torch._int_mm and the bound
    timed = {}
    for name, (k, stride, shape, o) in v3_shapes.items():
        shape = (BATCH, *shape[1:])
        xq, wq, st, pad, kw = int8_case(rng, k, stride, shape, o,
                                        {"sx": "static", "act": "leaky"}, dev)
        key = "int8_gemm" if k == 1 and stride == 1 else "int8_conv"
        ref = run_int8(kernels, xq, wq, st, pad, kw, plain=True)
        for mma in (False, True):
            got = run_int8(kernels, xq, wq, st, pad, kw, mma=mma)
            errs[key] = max(errs[key], max_err(got, ref))
            if not bool((abs_diff(got, ref) <= 1e-6 * ref.abs()).all()):
                fail(f"{key} {name} batch {BATCH} (mma={mma}): kernel disagrees with its "
                     "plain version")
        del ref
        new = lambda: run_int8(kernels, xq, wq, st, pad, kw)  # noqa: E731
        old = lambda: run_int8(kernels, xq, wq, st, pad, kw, mma=True)  # noqa: E731
        new_ms, old_ms = in_turns(old, new)
        dev_ms = graph_ms(new)
        pms = time_ms(lambda: run_int8(kernels, xq, wq, st, pad, kw, plain=True), 5, 1)
        xb = xq.permute(0, 3, 1, 2).to(torch.bfloat16)  # channels_last, as the bf16 path
        wb = wq.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = kw["b"].to(torch.bfloat16)
        cms = time_ms(lambda: torch.nn.functional.conv2d(xb, wb, bb, stride=st, padding=pad))
        ims = None
        if key == "int8_gemm":  # int8 -> int32, no epilogue
            x2, w2 = xq.reshape(-1, xq.shape[-1]), wq.reshape(o, -1)
            ims = time_ms(lambda: torch._int_mm(x2, w2.t()))
        ops, nbytes = kernels.igemm_work(tuple(xq.shape), tuple(wq.shape), st, pad, 4)
        bms, by = bound(ops, nbytes, PEAK_INT8_OPS)
        timed[name] = dict(key=key, ms=new_ms, device_ms=dev_ms, old_ms=old_ms, plain_ms=pms,
                           cudnn_ms=cms, int_mm_ms=ims, bound_ms=bms, bound_by=by)
        say(f"phase 9 {key} {name} batch {BATCH} (static sx, leaky, fp32 out): wgmma "
            f"{new_ms:.4f} ms ({ops / new_ms / 1e9:.1f} TOPS, {bms / new_ms:.1%} of bound; "
            f"device {dev_ms:.4f} ms), "
            f"mma.sync {old_ms:.4f} ms ({bms / old_ms:.1%}), plain {pms:.4f} ms, cuDNN bf16 "
            f"conv {cms:.4f} ms"
            + (f", torch._int_mm {ims:.4f} ms" if ims is not None else "")
            + f"; bound {bms:.4f} ms ({by}: {ops / 1e9:.1f} G ops, {nbytes / 1e6:.1f} MB); "
            f"on {card}")
        del xq, wq, xb, wb, got
    g9, c9 = timed["1x1 52² 256->128"], timed["3x3 s1 52² 128->256"]
    say(f"phase 9 timings: {json.dumps(timed, ensure_ascii=False)}")

    # 10. live weights: the equalizer on the card, fp32 card vs CPU
    from pytorch_yolo_tpu_torch.utils.drift import measure_mode_drift
    from pytorch_yolo_tpu_torch.weights import (equalize_raw_params, fold_batchnorm,
                                                random_raw_params)

    t0 = time.perf_counter()
    info = {}
    live = fold_batchnorm(v3, equalize_raw_params(v3, random_raw_params(v3), device=dev,
                                                  info=info))
    eq_s = time.perf_counter() - t0
    det_ref = Detector(v3, live, device=dev, precision="highest")
    det_load = Detector.load(cfg, device=dev, precision="highest", synthetic="live")
    det_cpu = Detector(v3, live, device="cpu", precision="highest")
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    gpu = det_load.detect_batch(frames4[:2], size=SIZE)
    torch.cuda.synchronize()
    launches10 = dict(kernels.LAUNCHES)
    if not (launches10["decode_score"] == 1 and launches10["nms_keep"] == 1):
        fail(f"live detect_batch on the card: expected one K1 and one K2 launch: {launches10}")
    same = detection_drift(det_ref.detect_batch(frames4[:2], size=SIZE), gpu)
    cpu = det_cpu.detect_batch(frames4[:2], size=SIZE)
    stats10 = detection_drift(cpu, gpu)
    if not (same.ref_dets > 0 and same.set_agreement == 1.0):
        fail(f"Detector.load(synthetic='live') differs from the equalized weights: {same.row()}")
    if not (stats10.ref_dets > 0 and stats10.set_agreement == 1.0):
        fail(f"live fp32 card vs CPU: {stats10.row()}")
    say(f"phase 10 yolov3@{SIZE} live weights: equalizer {info['sweeps']} sweeps "
        f"(converged {info['converged']}, largest |log std| after the last "
        f"{info['max_log_std']:.4f}, unscaled convs {info['unscaled']}) in {eq_s:.1f} s on the card; "
        f"fp32 highest, 2 frames, card vs CPU: {stats10.row()}; launches {launches10}")
    del det_load, det_cpu

    # 11. drift on the card against fp32 "highest", live weights
    img_rng = np.random.default_rng(0)
    drift_imgs = [img_rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
    calib_live = [np.random.default_rng(100 + i).integers(0, 256, (480, 640, 3), dtype=np.uint8)
                  for i in range(4)]
    bf16 = dict(dtype=torch.bfloat16, precision="default")
    static = dict(quant_calib=calib_live, quant_calib_size=SIZE)
    modes = {"bf16 s2d": dict(stem_s2d=True, **bf16),
             "bf16 natural stem": dict(stem_s2d=False, **bf16),
             "int8 dynamic": dict(quant="w8a8"),
             "int8-static none": dict(quant="w8a8", quant_recipe="none", **static),
             "int8sb none": dict(quant="w8a8", quant_recipe="none", **static, **bf16),
             "int8sb auto": dict(quant="w8a8", **static, **bf16)}
    ref_stats = None
    rows11 = {}
    for name, kw in modes.items():
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        t0 = time.perf_counter()
        det = Detector(v3, live, device=dev, **kw)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        calib_launches = dict(kernels.LAUNCHES)
        st = measure_mode_drift(det_ref, det, drift_imgs, size=SIZE)
        torch.cuda.synchronize()
        launches11 = {k: v - calib_launches[k] for k, v in kernels.LAUNCHES.items()}
        if ref_stats is None:
            ref = [det_ref.detect(im, size=SIZE) for im in drift_imgs]
            ref_stats = detection_drift(ref, ref)
        if st.degenerate:
            fail(f"drift {name}: degenerate regime: {st.row()}")
        if not (launches11["decode_score"] == 2 * len(drift_imgs)
                and launches11["nms_keep"] == 2 * len(drift_imgs)):
            fail(f"drift {name}: expected one K1 and one K2 launch a frame: {launches11}")
        if name == "int8sb auto" and not (calib_launches["int8_gemm"]
                                          and calib_launches["int8_conv"]):
            fail(f"the recipe's calibration bypassed K3/K4: {calib_launches}")
        if kw.get("quant") and not (launches11["int8_gemm"] and launches11["int8_conv"]):
            fail(f"drift {name}: int8 serving bypassed K3/K4: {launches11}")
        rows11[name] = dict(agree=st.set_agreement, box_p99=st.box_p99_px, score_p99=st.score_p99,
                            load_s=load_s, stem_s2d=det.stem_s2d, recipe=det.quant_state().get(
                                "recipe") if det.quant else None)
        say(f"phase 11 drift yolov3@{SIZE} live, {name} (stem_s2d={det.stem_s2d}) vs fp32 "
            f"highest: {st.row()}; load+calibrate {load_s:.2f} s; calibration launches "
            f"{ {k: v for k, v in calib_launches.items() if v} }")
        del det
    if ref_stats.ref_sat_frac > 0.5 or ref_stats.ref_score_spread < 0.02:
        fail(f"the live fp32 reference is degenerate: {ref_stats.row()}")
    if not rows11["int8sb auto"]["agree"] > rows11["int8sb none"]["agree"]:
        fail(f"int8sb 'auto' does not beat 'none': {rows11['int8sb auto']['agree']:.4f} vs "
             f"{rows11['int8sb none']['agree']:.4f}")
    say(f"phase 11 fp32 reference: {ref_stats.ref_dets} dets, saturated share "
        f"{ref_stats.ref_sat_frac:.2f}, score spread {ref_stats.ref_score_spread:.3f} (not degenerate)")
    say(f"phase 11 rows: {json.dumps(rows11)}")
    tiny_spec = load_model_spec(tiny)
    tiny_live = fold_batchnorm(tiny_spec, equalize_raw_params(tiny_spec, random_raw_params(tiny_spec),
                                                              device=dev))
    det_gpu = Detector(tiny_spec, tiny_live, device=dev, quant="w8a8", quant_calib=calib_live,
                       quant_calib_size=SIZE)
    state = json.loads(json.dumps(det_gpu.quant_state()))
    if state.get("recipe") != "auto" or not state.get("bias_delta"):
        fail(f"yolov3-tiny bare quant_calib did not serve the recipe: {sorted(state)}")
    det_cpu = Detector(tiny_spec, tiny_live, device="cpu", quant="w8a8",
                       quant_act_scales=state["scales"], quant_skip_layers=frozenset(state["skip"]),
                       quant_bias_delta=state["bias_delta"])
    gpu = det_gpu.detect_batch(frames4, size=SIZE, conf=0.5, iou=IOU, max_det=MAX_DET)
    stats11 = detection_drift(det_cpu.detect_batch(frames4, size=SIZE, conf=0.5, iou=IOU,
                                                   max_det=MAX_DET), gpu)
    if not (stats11.ref_dets > 0 and stats11.set_agreement >= 0.995):
        fail(f"yolov3-tiny live 'auto' card vs CPU: {stats11.row()}")
    say(f"phase 11 yolov3-tiny@{SIZE} live w8a8 'auto' calibrated on the card, CPU on the card's "
        f"state: set agreement {stats11.set_agreement:.4f} (>= 0.995); {stats11.row()}")
    del det_gpu, det_cpu, det_ref

    # 12. A/B at batch 128 on the live weights: the s2d stem, the recipe, K2
    def pipeline_median(det_ab) -> float:
        times_ab, _ = pipeline_ms(lambda: det_ab.raw_result(frames, size=SIZE, conf=CONF, iou=IOU,
                                                            max_det=MAX_DET))
        return statistics.median(times_ab)

    ab = {}
    for tag, make in (("bf16 s2d", lambda s2d: Detector(v3, live, device=dev, stem_s2d=s2d,
                                                          **bf16)),
                      ("int8sb recipe", lambda auto: Detector(
                          v3, live, device=dev, quant="w8a8",
                          quant_recipe=None if auto else "none", **static, **bf16))):
        off, on = make(False), make(True)
        t_off1, t_on1, t_on2, t_off2 = (pipeline_median(off), pipeline_median(on),
                                        pipeline_median(on), pipeline_median(off))
        ab[tag] = dict(off=[t_off1, t_off2], on=[t_on1, t_on2],
                       gain=(t_off1 + t_off2) / (t_on1 + t_on2) - 1.0,
                       stem_s2d=[off.stem_s2d, on.stem_s2d])
        say(f"phase 12 {tag} A/B, yolov3@{SIZE} live batch {BATCH} (off, on, on, off): "
            f"off {t_off1:.3f} / {t_off2:.3f}, on {t_on1:.3f} / {t_on2:.3f} ms/batch; "
            f"on is {ab[tag]['gain']:+.2%} faster ({BATCH / statistics.mean([t_on1, t_on2]) * 1e3:.1f}"
            f" vs {BATCH / statistics.mean([t_off1, t_off2]) * 1e3:.1f} img/s) on {card}")
        if tag == "bf16 s2d":
            det12 = Detector(v3, live, device=dev, **bf16)  # the default stem
        del off, on
    # where the s2d stem's time goes: the stem alone, natural and packed
    stem_on = Detector(v3, live, device=dev, stem_s2d=True, **bf16).model
    xs = letterbox_batch(frames, SIZE)
    nat0, nat1 = det12.model.convs["0"], det12.model.convs["1"]
    from pytorch_yolo_tpu_torch.models.darknet import _space_to_depth, apply_activation

    with torch.no_grad():
        xn = xs.permute(0, 3, 1, 2).to(torch.bfloat16)
        y0n = apply_activation(nat0(xn), "leaky")
        ys = _space_to_depth(xs).permute(0, 3, 1, 2).to(torch.bfloat16)
        y0s = apply_activation(stem_on.stem0(ys), "leaky")
        y0p = torch.nn.functional.pad(y0s, (1, 0, 1, 0))
        parts = {
            "natural conv0+leaky": lambda: apply_activation(nat0(xn), "leaky"),
            "natural conv1+leaky": lambda: apply_activation(nat1(y0n), "leaky"),
            "s2d permute+cast": lambda: _space_to_depth(xs).permute(0, 3, 1, 2).to(torch.bfloat16),
            "s2d conv0+leaky": lambda: apply_activation(stem_on.stem0(ys), "leaky"),
            "s2d pad": lambda: torch.nn.functional.pad(y0s, (1, 0, 1, 0)),
            "s2d conv1+leaky": lambda: apply_activation(stem_on.stem1(y0p), "leaky")}
        stem_ms = {k: time_ms(f, 10, 2) for k, f in parts.items()}
    layouts = {k: bool(t.is_contiguous(memory_format=torch.channels_last))
               for k, t in (("natural conv0 out", y0n), ("s2d input", ys), ("s2d conv0 out", y0s),
                            ("s2d pad out", y0p))}
    say(f"phase 12 stem alone, bf16 batch {BATCH} (eager ms): {json.dumps(stem_ms)}; "
        f"channels_last {layouts}")
    del stem_on, xs, xn, y0n, ys, y0s, y0p
    with torch.no_grad():
        heads = det12.model(letterbox_batch(frames, SIZE), _native_heads=True)
    rows = kernels.decode_score_all(heads, det12.spec)
    masked = torch.where(rows[..., 4] > CONF, rows[..., 7], torch.full_like(rows[..., 7], -1.0))
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    sel = torch.gather(rows, 1, idx[:, :MAX_DET, None].expand(BATCH, MAX_DET, 8))
    lboxes, lcls = sel[..., :4].contiguous(), sel[..., 6].contiguous()
    lvalid = (top[:, :MAX_DET] > 0).contiguous()
    lkeep = kernels.nms_keep(lboxes, lvalid, IOU, lcls)
    if not torch.equal(lkeep, kernels.nms_keep_ref(lboxes, lvalid, IOU, lcls)):
        fail("K2 on the live step's candidates disagrees with its plain version")
    over = iou_matrix(lboxes) > IOU
    over &= (lcls[:, :, None] - lcls[:, None, :]).abs() < 0.5
    live_rounds = fixpoint_rounds(over, lvalid)
    suppressed = int((lvalid & ~lkeep).sum())
    k2l = lambda: kernels.nms_keep(lboxes, lvalid, IOU, lcls)  # noqa: E731
    k2l_ms, k2l_dev_ms = time_ms(k2l), graph_ms(k2l)
    k2l_bound, k2l_by = k2_bound_of(lvalid, True)
    say(f"phase 12 K2 nms_keep {BATCH}x{MAX_DET} on the live step's candidates "
        f"({int(lvalid.sum())} valid, {suppressed} suppressed, fixpoint rounds {live_rounds}): "
        f"{k2l_ms:.4f} ms eager, {k2l_dev_ms:.4f} ms device ({k2l_bound / k2l_dev_ms:.1%} of "
        f"{k2l_bound:.5f} ms, {k2l_by}); phase 6's degenerate candidates {k2_dev_ms:.4f} ms device "
        f"(fixpoint rounds {rounds})")
    say(f"phase 12 timings: {json.dumps(ab)}")
    del det12, heads, rows

    report = {"kernels": [
        {"name": "decode_score", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/decode_score.cu",
         "replaces": "pytorch_yolo_tpu/ops/pallas_kernels.py:110",
         "launches": launches["decode_score"], "max_abs_err": max(k1_err, k1_main_err),
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "device_ms": k1_dev_ms,
         # the same heads cast to fp32 + K1, and K1 on fp32 heads (device time)
         "cast_ms": k1_cast_dev_ms, "fp32_ms": k1_32_dev_ms},
        {"name": "nms_keep", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/nms_keep.cu",
         "replaces": "pytorch_yolo_tpu/ops/pallas_kernels.py:312",
         "launches": launches["nms_keep"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by,
         "library_ms": None, "device_ms": k2_dev_ms, "crowded_device_ms": k2_crowd_dev_ms},
        {"name": "int8_gemm", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/gemm_i8.cu",
         "replaces": "tools/int8_kernel_probe.py:181",
         "launches": launches9["int8_gemm"], "max_abs_err": errs["int8_gemm"],
         "ms": g9["ms"], "plain_ms": g9["plain_ms"], "bound_ms": g9["bound_ms"],
         "bound_by": g9["bound_by"], "library_ms": g9["int_mm_ms"],
         "device_ms": g9["device_ms"], "v1_ms": g9["old_ms"]},  # the mma.sync core
        {"name": "int8_conv", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/int8_conv.cu",
         "replaces": "pytorch_yolo_tpu/ops/quant.py:564",
         "launches": launches9["int8_conv"], "max_abs_err": errs["int8_conv"],
         "ms": c9["ms"], "plain_ms": c9["plain_ms"], "bound_ms": c9["bound_ms"],
         "bound_by": c9["bound_by"], "library_ms": c9["cudnn_ms"],
         "device_ms": c9["device_ms"], "v1_ms": c9["old_ms"]},
    ]}
    say(json.dumps(report))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

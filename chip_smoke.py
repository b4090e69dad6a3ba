#!/usr/bin/env python3
"""Drive the PyTorch port's detection main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one line each (a failure in any phase exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from ``pytorch_yolo_tpu_torch/csrc``;
  3. K1 decode+score against its plain torch version on the card, at the
     yolov3@416 head shapes (batch 8) plus a [region] softmax head and a
     4-anchor new_coords head;
  4. K2 NMS keep mask against its plain version, K = 300, batch 8, crowded
     boxes with ties and mixed classes (masks must be equal);
  5. ``Detector.load("cfg/yolov3.cfg", device="cuda")`` fp32 / "highest"
     against the same detector on the CPU on four 480x640 uint8 frames
     (set agreement must be 1.0), counting kernel launches;
  6. the serving configuration of ``bench.py``: yolov3@416, bf16, batch 128,
     480x640 uint8 frames already on the device, conf 0.6, iou 0.45,
     max_det 300 — median ms/batch and img/s over 20 timed iterations after
     3 warm-up ones (CUDA events), with the launch counts of that run; then
     K1's and K2's times beside their plain versions' at those shapes.

The second-to-last line is the card as nvidia-smi names it; the last line
is ``{"ok": true, "device": {...}}``.  Without CUDA, or run outside the
repository, the script exits non-zero and prints no result.
Synthetic He-init weights (seed 0), frames from numpy seed 0.
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


def in_turns(plain, kernel) -> tuple[float, float]:
    """Plain, kernel, kernel, plain; the mean of each pair (one card, one call)."""
    p1, k1, k2, p2 = time_ms(plain), time_ms(kernel), time_ms(kernel), time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


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
        ours = kernels.decode_score_head(raw, anchors, stride, head.classes, cls_act=cls_act,
                                         scale_xy=sxy, new_coords=nc)
        ref = kernels.decode_score_head_ref(raw, anchors, stride, head.classes, cls_act=cls_act,
                                            scale_xy=sxy, new_coords=nc)
        torch.cuda.synchronize()
        err = max_err(ours, ref)
        if not rows_close(ours, ref):
            fail(f"K1 {name}: kernel disagrees with its plain version (max abs err {err})")
        if head in v3.yolo_layers:
            k1_err = max(k1_err, err)
        say(f"phase 3 K1 {name} {tuple(shape)}: ok, max abs err {err:.3g} "
            f"(tol {TOL} rel. to row corners; cls_id exact)")
    ties = torch.zeros((2, 13, 13, 3 * 85), device=dev)
    ties[..., [5 + 2, 85 + 5 + 2, 170 + 5 + 2]] = 3.0
    ties[..., [5 + 4, 85 + 5 + 4, 170 + 5 + 4]] = 3.0
    tied = kernels.decode_score_head(ties, v3.yolo_layers[0].anchors, 32, 80)
    if not bool((tied[..., 6] == 2).all()):
        fail("K1 class tie: the lowest class index must win")
    say("phase 3 K1 class tie: ok (lowest index wins)")

    # 4. K2 against its plain version
    k2_err = 0.0
    for class_wise in (True, False):
        boxes, valid, cls = crowded_boxes(rng, 8, MAX_DET, dev)
        c = cls if class_wise else None
        ours = kernels.nms_keep(boxes, valid, IOU, c)
        ref = kernels.nms_keep_ref(boxes, valid, IOU, c)
        torch.cuda.synchronize()
        diff = int((ours != ref).sum())
        k2_err = max(k2_err, float(diff))
        if diff:
            fail(f"K2 class_wise={class_wise}: {diff} keep entries differ from the plain version")
        say(f"phase 4 K2 K={MAX_DET} batch 8 class_wise={class_wise}: ok, keep masks equal "
            f"({int(ours.sum())} kept of {int(valid.sum())} valid)")

    # 5. the slice at fp32 on the card against the CPU
    frames4 = rng.integers(0, 256, size=(4, 480, 640, 3), dtype=np.uint8)
    det_gpu = Detector.load(cfg, device=dev, precision="highest")
    det_cpu = Detector.load(cfg, device="cpu", precision="highest")
    kernels.LAUNCHES.update(decode_score=0, nms_keep=0)
    gpu = det_gpu.detect_batch(frames4, size=SIZE, conf=CONF, iou=IOU, max_det=MAX_DET)
    torch.cuda.synchronize()
    launches5 = dict(kernels.LAUNCHES)
    if not (launches5["decode_score"] and launches5["nms_keep"]):
        fail(f"fp32 detect_batch on the card bypassed a kernel: {launches5}")
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

    kernels.LAUNCHES.update(decode_score=0, nms_keep=0)
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
    launches = dict(kernels.LAUNCHES)
    if not (launches["decode_score"] and launches["nms_keep"]):
        fail(f"the bf16 main path bypassed a kernel: {launches}")
    if tuple(res.boxes.shape) != (BATCH, MAX_DET, 4) or not bool(res.valid.any()):
        fail(f"bf16 result has shape {tuple(res.boxes.shape)} and "
             f"{int(res.valid.sum())} valid rows")
    if not bool(torch.isfinite(res.boxes[res.valid]).all()):
        fail("bf16 result has non-finite kept boxes")
    ms = statistics.median(times)
    say(f"phase 6 yolov3@{SIZE} bf16 batch {BATCH} pipeline: median {ms:.3f} ms/batch, "
        f"{BATCH / ms * 1e3:.1f} img/s (min {min(times):.3f}, max {max(times):.3f} ms; "
        f"{int(res.valid.sum())} kept) on {card}; launches {launches}")

    # kernel times at the main path's shapes, beside the plain versions
    with torch.no_grad():
        heads = det.model(letterbox_batch(frames, SIZE))
    spec = det.spec

    def k1():
        return kernels.decode_score_all(heads, spec)

    def k1_plain():
        outs = []
        for raw, head, stride in zip(heads, spec.yolo_layers, head_strides(spec)):
            anchors, cls_act, sxy, nc = head_decode_args(head, stride)
            outs.append(kernels.decode_score_head_ref(raw, anchors, stride, head.classes,
                                                      cls_act=cls_act, scale_xy=sxy,
                                                      new_coords=nc))
        return torch.cat(outs, dim=1)

    rows = k1()
    k1_main_err = max_err(rows, k1_plain())
    if not rows_close(rows, k1_plain()):
        fail(f"K1 on the main path's heads disagrees with its plain version ({k1_main_err})")
    masked = torch.where(rows[..., 4] > CONF, rows[..., 7], torch.full_like(rows[..., 7], -1.0))
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    sel = torch.gather(rows, 1, idx[:, :MAX_DET, None].expand(BATCH, MAX_DET, 8))
    boxes, cls_f = sel[..., :4].contiguous(), sel[..., 6].contiguous()
    valid = (top[:, :MAX_DET] > 0).contiguous()
    if not torch.equal(kernels.nms_keep(boxes, valid, IOU, cls_f),
                       kernels.nms_keep_ref(boxes, valid, IOU, cls_f)):
        fail("K2 on the main path's candidates disagrees with its plain version")
    k1_ms, k1_plain_ms = in_turns(k1_plain, k1)
    k2_ms, k2_plain_ms = in_turns(lambda: kernels.nms_keep_ref(boxes, valid, IOU, cls_f),
                                  lambda: kernels.nms_keep(boxes, valid, IOU, cls_f))
    say(f"phase 6 K1 decode_score_all (3 heads, batch {BATCH}): {k1_ms:.4f} ms, plain "
        f"{k1_plain_ms:.4f} ms; K2 nms_keep ({BATCH}x{MAX_DET}): {k2_ms:.4f} ms, plain "
        f"{k2_plain_ms:.4f} ms; on {card}")

    report = {"kernels": [
        {"name": "decode_score", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/decode_score.cu",
         "replaces": "pytorch_yolo_tpu/ops/pallas_kernels.py:110",
         "launches": launches["decode_score"], "max_abs_err": max(k1_err, k1_main_err),
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "nms_keep", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/nms_keep.cu",
         "replaces": "pytorch_yolo_tpu/ops/pallas_kernels.py:312",
         "launches": launches["nms_keep"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]}
    say(json.dumps(report))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

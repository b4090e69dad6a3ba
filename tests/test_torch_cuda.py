"""The port's CUDA kernels against their plain torch versions, on the card.

Every case here needs an NVIDIA GPU and skips where
``torch.cuda.is_available()`` is false.  The file imports neither jax nor
the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: ``tests/conftest.py`` imports jax).  The case tables are
shared with ``tests/test_torch_kernels.py``, which holds the same plain
versions against the JAX package's Pallas kernels on the CPU.

Tolerances: decode rows rtol = atol = 1e-5 (``expf`` and summation order),
with box columns relative to the row's largest corner (a corner is a
difference of two values up to ~1e4 px); ``cls_id`` and keep masks exact.
K1 on bf16 heads equals K1 on their fp32 widening exactly (the widening
is exact, the arithmetic after the load the same), and its one launch over
every head equals one launch a head.
The int8 kernels K3/K4: int32 accumulators and int8 outputs exact; fp32
outputs within 1e-6 relative (the kernels follow the plain versions'
operation order, each multiply-add one explicit FMA as in the plain
versions' ``fma``; only ``expf``/``log1pf``/``tanhf`` in mish and logistic
may differ in the last ulps); with a [shortcut] operand, within 1e-6 of the
larger of the output and the operand (the add may cancel most of a mish
output that differs in its last ulp).  K6: int8 equal, ``max|x|`` bit-equal.
"""

import numpy as np
import pytest
import torch

import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch.config import MaxPoolSpec
from pytorch_yolo_tpu_torch.models.darknet import _maxpool, _reorg
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch, letterbox_host
from pytorch_yolo_tpu_torch.ops.quant import dynamic_scale, scale_of_amax
from pytorch_yolo_tpu_torch.utils.drift import detection_drift

ANCHORS = ((81, 82), (135, 169), (344, 319))
ANCHORS4 = ((12, 16), (19, 36), (40, 28), (36, 75))
REGION = tuple((w * 32, h * 32) for w, h in ((0.57273, 0.677385), (1.87446, 2.06253),
                                              (3.33843, 5.47434), (7.88282, 3.52778),
                                              (9.77052, 9.16828)))


def assert_rows_close(ours, ref, rtol=1e-6, atol=1e-6):
    """(…, 8) decode rows: see the module docstring for the box-column bound."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    scale = np.abs(ref[..., :4]).max(-1, keepdims=True)  # the row's largest corner
    assert (np.abs(ours[..., :4] - ref[..., :4]) <= atol + rtol * scale).all()
    np.testing.assert_allclose(ours[..., 4:6], ref[..., 4:6], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(ours[..., 6], ref[..., 6])
    np.testing.assert_allclose(ours[..., 7], ref[..., 7], rtol=rtol, atol=atol)


# (shape, anchors, stride, classes, kwargs, logit scale, pre-activated inputs)
DECODE_CASES = {
    "grid13": ((2, 13, 13, 255), ANCHORS, 32, 80, {}, 1.0, False),
    "grid26": ((2, 26, 26, 255), ANCHORS, 16, 80, {}, 1.0, False),
    "grid52": ((2, 52, 52, 255), ANCHORS, 8, 80, {}, 1.0, False),
    "rectangular": ((1, 8, 13, 255), ANCHORS, 32, 80, {}, 1.0, False),
    "region_softmax": ((2, 13, 13, 425), REGION, 32, 80, {"cls_act": "softmax"}, 2.0, False),
    "region_linear": ((1, 13, 13, 425), REGION, 32, 80, {"cls_act": "linear"}, 2.0, False),
    "scale_xy_1.05": ((2, 13, 13, 255), ANCHORS, 32, 80, {"scale_xy": 1.05}, 2.0, False),
    "scale_xy_1.2": ((2, 13, 13, 255), ANCHORS, 32, 80, {"scale_xy": 1.2}, 2.0, False),
    "new_coords_4anchor": ((2, 8, 8, 4 * 85), ANCHORS4, 8, 80,
                           {"cls_act": "linear", "scale_xy": 2.0, "new_coords": True}, 1.0, True),
    "obj_times_cls": ((1, 13, 13, 255), ANCHORS, 32, 80, {"score_mode": "obj*cls"}, 1.0, False),
}


def decode_input(name):
    shape, _, _, _, _, scale, pre = DECODE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if pre:  # new_coords heads see values a logistic conv already squashed
        return rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    return rng.normal(0.0, scale, size=shape).astype(np.float32)


def crowded_boxes(seed, n, k):
    """(N, K, 4) corner boxes in overlapping clusters, some exact duplicates,
    (N, K) valid with ~15% invalid rows, (N, K) class ids in 0..3."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(40, 376, size=(n, max(k // 12, 1), 2))
    pick = rng.integers(0, centers.shape[1], size=(n, k))
    cxy = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 8, (n, k, 2))
    wh = rng.uniform(10, 90, size=(n, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    dup = rng.uniform(size=(n, k)) < 0.1
    boxes[:, 1:][dup[:, 1:]] = boxes[:, :-1][dup[:, 1:]]  # ties with the row above
    valid = rng.uniform(size=(n, k)) > 0.15
    cls = rng.integers(0, 4, size=(n, k)).astype(np.float32)
    return boxes, valid, cls


def nms_input(seed, n, k):
    """(boxes, valid, cls) of an NMS case: an int seed gives
    :func:`crowded_boxes`; a name gives an edge case of K candidates:
    "chain" (box i overlaps box i+1 only, IoU 0.5, and box i+2 at IoU 0.2:
    greedy keeps every other box, the fixpoint takes K rounds), "crowded"
    (crowded boxes at an odd K), "all_invalid", "identical" (every box the
    same, all valid), "nan_corners" (crowded, one corner NaN in ~15% of
    rows)."""
    if not isinstance(seed, str):
        return crowded_boxes(seed, n, k)
    if seed == "chain":
        x = np.arange(k, dtype=np.float32)
        row = np.stack([x, np.zeros_like(x), x + 3, np.full_like(x, 10)], -1)
        return (np.broadcast_to(row, (n, k, 4)).copy(), np.ones((n, k), bool),
                np.zeros((n, k), np.float32))
    boxes, valid, cls = crowded_boxes(k, n, k)
    if seed == "all_invalid":
        valid[:] = False
    elif seed == "identical":
        boxes[:] = boxes[:, :1]
        valid[:] = True
    elif seed == "nan_corners":
        rng = np.random.default_rng(k)
        nan = rng.uniform(size=(n, k)) < 0.15
        boxes[nan, rng.integers(0, 4, int(nan.sum()))] = np.nan
    return boxes, valid, cls


# (seed or edge case, K, class-wise)
NMS_CASES = ([(seed, k, cw) for seed, k in ((0, 37), (1, 96), (2, 300)) for cw in (False, True)]
             + [(kind, k, cw) for kind, k in (("chain", 300), ("crowded", 1), ("crowded", 31),
                                              ("crowded", 32), ("crowded", 33),
                                              ("all_invalid", 64), ("identical", 40),
                                              ("nan_corners", 96))
                for cw in (False, True)])
# the card only: the kernels' largest K (the plain fixpoint takes 1024 rounds on the chain)
NMS_CARD_CASES = NMS_CASES + [(kind, 1024, cw) for kind in ("chain", 3) for cw in (False, True)]
# the card only: K2's large-K mode (the bitmask in global memory)
NMS_LARGE_CASES = [(seed, k, cw) for seed, k in ((4, 1025), (5, 2048), (6, 3001))
                   for cw in (False, True)]


# The bf16 yolov3-tiny's heads, card against CPU (relative L2): a limit set
# between K5's reading, 0.00434 / 0.00354, and the replaced conv's, 0.00864
# / 0.00739 (``tools/k5_accuracy.py`` on an H100 80GB HBM3, 700 W).
K5_DETECTOR_L2 = 0.006

# K5 cases: name -> (N, H, W, C, O, kernel size, stride, activation, bias,
# shortcut).  Bias "normal" is N(0, 0.5); "cancel" is minus the mean of the
# fp32 conv per channel, so the outputs centre on zero, where the bias
# cancels the sum.
CONV_BF16_CASES = {
    "3x3 s1 26² 128->256 leaky": (1, 26, 26, 128, 256, 3, 1, "leaky", "normal", False),
    **{f"3x3 s1 20² 64->64 {act}": (1, 20, 20, 64, 64, 3, 1, act, "normal", False)
       for act in ("mish", "relu", "logistic", "linear")},
    "stem 3x3 s1 64² 3->32 leaky": (1, 64, 64, 3, 32, 3, 1, "leaky", "normal", False),
    "1x1 26² 128->64 leaky": (2, 26, 26, 128, 64, 1, 1, "leaky", "normal", False),
    "3x3 s2 52²->26² 64->128 leaky": (1, 52, 52, 64, 128, 3, 2, "leaky", "normal", False),
    "3x3 s1 20² 64->64 leaky cancelling bias": (1, 20, 20, 64, 64, 3, 1, "leaky", "cancel",
                                                False),
    "1x1 26² 64->128 leaky + shortcut": (1, 26, 26, 64, 128, 1, 1, "leaky", "normal", True),
    "1x1 13² 256->255 linear head": (2, 13, 13, 256, 255, 1, 1, "linear", "normal", False),
    # K = 4608, the deepest chain, two images: tiles span the image boundary
    "3x3 s1 13² 512->1024 leaky": (2, 13, 13, 512, 1024, 3, 1, "leaky", "normal", False),
    "3x3 s2 13²->7² 256->512 leaky": (1, 13, 13, 256, 512, 3, 2, "leaky", "normal", False),
    "3x3 s1 26² 32->64 leaky": (1, 26, 26, 32, 64, 3, 1, "leaky", "normal", False),  # C = 32
    # yolov4@608's conv 11 (mish, 304² -> 152²) with a [shortcut] operand
    "3x3 s2 304²->152² 64->128 mish + shortcut": (1, 304, 304, 64, 128, 3, 2, "mish", "normal",
                                                  True),
}


# K5 at the Scaled-YOLOv4 convs that no earlier model ran, at batch 1 and
# the published input sizes: yolov4x-mish@640's convs that the gather route
# ran before the "im2col16" route (C % 32 != 0: C = 40 and 80, 16-channel
# boxes, tiles of 48 and 80 columns) and its 3->40 stem (the packed route,
# a 48-column tile), its 1x1 convs at C = 80 (A by TMA, K past C
# zero-filled), and the bias-only logistic head convs of both models (1x1,
# A by TMA).  Same layout as CONV_BF16_CASES.
CSP_CONV_CASES = {
    "x-mish conv 0 3x3 s1 640² 3->40 mish": (1, 640, 640, 3, 40, 3, 1, "mish", "normal", False),
    "x-mish conv 1 3x3 s2 640²->320² 40->80 mish": (1, 640, 640, 40, 80, 3, 2, "mish", "normal",
                                                    False),
    "x-mish conv 2 1x1 320² 80->40 mish": (1, 320, 320, 80, 40, 1, 1, "mish", "normal", False),
    "x-mish conv 3 3x3 s1 320² 40->80 mish + shortcut": (1, 320, 320, 40, 80, 3, 1, "mish",
                                                         "normal", True),
    "x-mish conv 5 3x3 s2 320²->160² 80->160 mish": (1, 320, 320, 80, 160, 3, 2, "mish",
                                                     "normal", False),
    "x-mish conv 10 3x3 s1 160² 80->80 mish + shortcut": (1, 160, 160, 80, 80, 3, 1, "mish",
                                                          "normal", True),
    "csp head 1x1 64² 256->255 logistic": (1, 64, 64, 256, 255, 1, 1, "logistic", "normal",
                                           False),
    "x-mish head 1x1 80² 320->255 logistic": (1, 80, 80, 320, 255, 1, 1, "logistic", "normal",
                                              False),
    "x-mish head 1x1 20² 1280->255 logistic": (1, 20, 20, 1280, 255, 1, 1, "logistic", "normal",
                                               False),
}


# K5 at the Scaled-YOLOv4 large family's convs that no earlier model ran,
# at batch 1 and yolov4-p7@1536's shapes: name -> (the route
# conv_bf16_plan must name, a CONV_BF16_CASES-style tuple).  Its 3x3 s1
# 40->40 conv at 768² (the halo route, a 48-column tile; with the
# [shortcut] its residual block fuses),
# a C = 480 residual conv (480 % 64 = 32: the "im2col_pad" route) and the
# 340-output logistic head convs at stride 8 and 128.
LARGE_CONV_CASES = {
    "p7 conv 6 3x3 s1 768² 40->40 mish + shortcut": (
        "halo", (1, 768, 768, 40, 40, 3, 1, "mish", "normal", True)),
    "p7 3x3 s1 48² 480->480 mish + shortcut": (
        "im2col_pad", (1, 48, 48, 480, 480, 3, 1, "mish", "normal", True)),
    "p7 head 1x1 192² 320->340 logistic": (
        "tma", (1, 192, 192, 320, 340, 1, 1, "logistic", "normal", False)),
    "p7 head 1x1 12² 1280->340 logistic": (
        "tma", (1, 12, 12, 1280, 340, 1, 1, "logistic", "normal", False)),
}


# K5 at the convs of yolov3-spp@608, yolov2@416 and yolov2-tiny@416 that no
# earlier model ran, at their published shapes: name -> (the route
# conv_bf16_plan must name, a CONV_BF16_CASES-style tuple).  yolov2's conv 29
# after the reorg route (1280 = 256 + 1024 channels), its 1x1 conv before the
# reorg and its 425-output [region] head conv; yolov2-tiny's stride-1 RGB stem
# (3 -> 16, the packed route) and its C = 16 conv (one 16-channel box a
# tap, the "im2col16" route);
# yolov3-spp's 2048 -> 512 conv after the SPP route.
V2_CONV_CASES = {
    "yolov2 conv 29 3x3 s1 13² 1280->1024 leaky": (
        "im2col", (2, 13, 13, 1280, 1024, 3, 1, "leaky", "normal", False)),
    "yolov2 conv 26 1x1 26² 512->64 leaky": (
        "tma", (2, 26, 26, 512, 64, 1, 1, "leaky", "normal", False)),
    "yolov2 head 1x1 13² 1024->425 linear": (
        "tma", (2, 13, 13, 1024, 425, 1, 1, "linear", "normal", False)),
    "yolov2-tiny stem 3x3 s1 416² 3->16 leaky": (
        "packed", (1, 416, 416, 3, 16, 3, 1, "leaky", "normal", False)),
    "yolov2-tiny conv 2 3x3 s1 208² 16->32 leaky": (
        "im2col16", (1, 208, 208, 16, 32, 3, 1, "leaky", "normal", False)),
    "yolov3-spp conv 84 1x1 19² 2048->512 leaky": (
        "tma", (2, 19, 19, 2048, 512, 1, 1, "leaky", "normal", False)),
}


# K5's packed route past 32 outputs, its "im2col16" route (C % 32 != 0,
# 16-channel boxes of one tap, four a stage, W repacked in box order) and
# its halo route (C % 16 == 8, at most 48 outputs: 4 x 32-pixel tiles from
# one box of their input pixels) at small grids: name -> (the route
# conv_bf16_plan must name, a CONV_BF16_CASES-style tuple).  The former
# gather convs' shapes at 24² (48² before a stride-2 conv): the 3->40
# stem, 40->80 s2, 80->160 s2 with and without a [shortcut], 16->32; and
# the edges: an odd M-tile count (17² = 289 pixels: 3 tiles, one past M;
# on the halo route tiles past the right and bottom edges), tiles that
# cross images, O = 40 / 80 / 160 (tiles of 48, 80, 2 x 80), C = 24 and 40
# (a last box of a tap half past C), C = 12 padded to 16, a stride-2 40->40
# conv (the halo route takes stride 1 only) with a [shortcut], the halo
# route on a 9 x 70 grid, 67 N-tiles of 128 (more than an H100's 66
# clusters: one cluster each, in two waves); and two convs the plan sends
# to the 16-byte gather, whose W (88 or 120 channels, 80 or 64 outputs)
# does not fit beside the "im2col16" ring.
BOX_CONV_CASES = {
    "stem 3x3 s1 24² 3->40 mish": ("packed", (1, 24, 24, 3, 40, 3, 1, "mish", "normal", False)),
    "stem 3x3 s2 48² 3->64 leaky": ("packed", (1, 48, 48, 3, 64, 3, 2, "leaky", "normal", False)),
    "stem 3x3 s1 17² 3->48 leaky, 2 images": (
        "packed", (2, 17, 17, 3, 48, 3, 1, "leaky", "normal", False)),
    "3x3 s2 48² 40->80 mish": ("im2col16", (1, 48, 48, 40, 80, 3, 2, "mish", "normal", False)),
    "3x3 s2 48² 80->160 mish": ("im2col16", (1, 48, 48, 80, 160, 3, 2, "mish", "normal", False)),
    "3x3 s2 48² 80->160 mish + shortcut": (
        "im2col16", (1, 48, 48, 80, 160, 3, 2, "mish", "normal", True)),
    "3x3 s1 24² 16->32 leaky": ("im2col16", (1, 24, 24, 16, 32, 3, 1, "leaky", "normal", False)),
    "3x3 s1 17² 40->40 mish, odd M-tiles": (
        "halo", (1, 17, 17, 40, 40, 3, 1, "mish", "normal", False)),
    "3x3 s2 37² 40->40 mish + shortcut, 2 images": (
        "im2col16", (2, 37, 37, 40, 40, 3, 2, "mish", "normal", True)),
    "3x3 s1 9x70 24->32 leaky cancelling bias": (
        "halo", (1, 9, 70, 24, 32, 3, 1, "leaky", "cancel", False)),
    "3x3 s1 13² 40->80 mish, 2 images": (
        "im2col16", (2, 13, 13, 40, 80, 3, 1, "mish", "normal", False)),
    "3x3 s1 13² 80->80 mish + shortcut, 2 images": (
        "im2col16", (2, 13, 13, 80, 80, 3, 1, "mish", "normal", True)),
    "3x3 s1 11² 40->80 leaky cancelling bias, 3 images": (
        "im2col16", (3, 11, 11, 40, 80, 3, 1, "leaky", "cancel", False)),
    "3x3 s2 21² 24->56 linear": ("im2col16", (1, 21, 21, 24, 56, 3, 2, "linear", "normal", False)),
    "3x3 s1 20² 12->128 leaky (C padded to 16)": (
        "im2col16", (1, 20, 20, 12, 128, 3, 1, "leaky", "normal", False)),
    "3x3 s1 5² 16->8576 linear, 67 N-tiles": (
        "im2col16", (1, 5, 5, 16, 8576, 3, 1, "linear", "normal", False)),
    "3x3 s1 13² 88->80 mish, W past the ring": (
        "gather", (1, 13, 13, 88, 80, 3, 1, "mish", "normal", False)),
    "3x3 s1 15² 120->64 leaky + shortcut, 2 images, W past the ring": (
        "gather", (2, 15, 15, 120, 64, 3, 1, "leaky", "normal", True)),
}


# K5's "im2col_pad" route (C % 64 == 32, C >= 160: boxes of 64 channels of
# one tap, ceil(C / 64) a tap, the last one's upper 32 channels TMA's zero
# fill, W repacked to 64 ceil(C / 64) channels; where O is a multiple of
# 160, 80-column tiles, the cluster's two CTAs on one M-tile): name -> (the
# route conv_bf16_plan must name, a CONV_BF16_CASES-style tuple).  The six
# shapes of yolov4x-mish's and yolov4-p7's C = 160 3x3 convs at batch 1
# (p7's 48² 480 -> 480 is in LARGE_CONV_CASES); and the edges: an odd
# M-tile count with tiles across images, C = 352 (six boxes a tap) with a
# cancelling bias and C = 224 (four) with O = 240 (128-column tiles; an
# odd count of 80-column ones in _pad_tiles), a 1x1 stride-2 conv (one
# tap), O <= 64 (a 64-column tile); and C = 96 and yolov3's C = 32 conv,
# which stay on "im2col32".
PAD_CONV_CASES = {
    "x-mish 3x3 s1 80² 160->160 mish + shortcut": (
        "im2col_pad", (1, 80, 80, 160, 160, 3, 1, "mish", "normal", True)),
    "x-mish 3x3 s2 160²->80² 160->320 mish": (
        "im2col_pad", (1, 160, 160, 160, 320, 3, 2, "mish", "normal", False)),
    "x-mish 3x3 s1 80² 160->320 mish": (
        "im2col_pad", (1, 80, 80, 160, 320, 3, 1, "mish", "normal", False)),
    "x-mish 3x3 s2 80²->40² 160->320 mish": (
        "im2col_pad", (1, 80, 80, 160, 320, 3, 2, "mish", "normal", False)),
    "p7 3x3 s1 192² 160->160 mish": (
        "im2col_pad", (1, 192, 192, 160, 160, 3, 1, "mish", "normal", False)),
    "p7 3x3 s2 384²->192² 160->320 mish": (
        "im2col_pad", (1, 384, 384, 160, 320, 3, 2, "mish", "normal", False)),
    "3x3 s1 17² 160->160 mish, odd M-tiles, 2 images": (
        "im2col_pad", (2, 17, 17, 160, 160, 3, 1, "mish", "normal", False)),
    "3x3 s2 21² 352->128 leaky cancelling bias": (
        "im2col_pad", (1, 21, 21, 352, 128, 3, 2, "leaky", "cancel", False)),
    "3x3 s1 26² 96->160 leaky": ("im2col32", (1, 26, 26, 96, 160, 3, 1, "leaky", "normal", False)),
    "3x3 s1 13² 224->240 linear + shortcut, 3 images": (
        "im2col_pad", (3, 13, 13, 224, 240, 3, 1, "linear", "normal", True)),
    "1x1 s2 26² 160->96 leaky": ("im2col_pad", (1, 26, 26, 160, 96, 1, 2, "leaky", "normal", False)),
    "3x3 s1 20² 160->64 mish": ("im2col_pad", (1, 20, 20, 160, 64, 3, 1, "mish", "normal", False)),
    "yolov3 3x3 s2 416²->208² 32->64 leaky": (
        "im2col32", (1, 416, 416, 32, 64, 3, 2, "leaky", "normal", False)),
}


def conv_bf16_input(name, device="cpu", case=None):
    """(x, w, b, stride, pad, activation, shortcut) of a K5 case (an entry of
    CONV_BF16_CASES, CSP_CONV_CASES, LARGE_CONV_CASES, V2_CONV_CASES,
    BOX_CONV_CASES or PAD_CONV_CASES, or ``case``, such an entry's tuple):
    NHWC bf16 x ~ N(0, 1), (O, KH, KW, C) bf16 He-scaled weights, fp32
    bias."""
    n, h, w_, c, o, k, stride, act, bias, shortcut = (
        case or CONV_BF16_CASES.get(name) or CSP_CONV_CASES.get(name)
        or {**LARGE_CONV_CASES, **V2_CONV_CASES, **BOX_CONV_CASES, **PAD_CONV_CASES}[name][1])
    rng = np.random.default_rng(sum(map(ord, name)))
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)  # noqa: E731
    x = bf(rng.normal(0, 1, (n, h, w_, c)))
    w = bf(rng.normal(0, np.sqrt(2.0 / (k * k * c)), (o, k, k, c)))
    pad = k // 2
    if bias == "cancel":
        y = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).float(), w.permute(0, 3, 1, 2).float(),
                                       stride=stride, padding=pad)
        b = -y.mean(dim=(0, 2, 3))
    else:
        b = torch.from_numpy(rng.normal(0, 0.5, o).astype(np.float32))
    ho, wo = (h + 2 * pad - k) // stride + 1, (w_ + 2 * pad - k) // stride + 1
    sc = bf(rng.normal(0, 1, (n, ho, wo, o))) if shortcut else None
    return (x.to(device), w.to(device), b.to(device), stride, pad, act,
            None if sc is None else sc.to(device))


def conv_bf16_floor(x, w, b, stride, pad, shortcut=None):
    """Per output, the largest difference two fp32 sums of the same K5 terms
    in different orders may show, however few bf16 steps apart they are:
    2^-20 (16 fp32 ulps) of sum |x w| + |b|, the scale of the terms
    (where the bias cancels the sum, the output is far smaller than that
    and its order error is many of its own bf16 steps); with a shortcut,
    plus one bf16 step of the conv output, which survives the add."""
    f = lambda t: t.detach().double().cpu()  # noqa: E731
    terms = torch.nn.functional.conv2d(f(x).abs().permute(0, 3, 1, 2),
                                       f(w).abs().permute(0, 3, 1, 2), stride=stride,
                                       padding=pad).permute(0, 2, 3, 1) + f(b).abs()
    floor = terms * 2.0 ** -20
    if shortcut is not None:
        floor = floor + terms * 2.0 ** -7
    return floor


def bf16_agreement(a, b, floor=None):
    """(share of equal outputs, largest distance in bf16 steps) of two
    tensors of bf16 values (bf16, or fp32 holding bf16 values); outputs
    whose difference is within ``floor`` (:func:`conv_bf16_floor`) do not
    count toward the distance."""
    def order(t):
        v = t.detach().cpu().to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)

    d = (order(a) - order(b)).abs()
    equal = float((d == 0).double().mean())
    if floor is not None:
        gap = (a.detach().cpu().double() - b.detach().cpu().double()).abs()
        d = torch.where(gap <= floor, torch.zeros_like(d), d)
    return equal, int(d.max())


# K3 (1x1 stride 1) and K4 cases: name -> (kernel size, stride, NHWC input
# shape, output channels, epilogue).  "sx": "dynamic" (a device max|x|/127),
# "static" (a 0-d scale), "vector" (a per-channel grid: deq = ws); "splits":
# per-branch scales; "out": "scalar"/"vector" requant to int8.  Shapes cover
# ragged M, N and K edges and the byte path (C not a multiple of 16), and
# the wgmma core's edges: more tiles than SMs, 256-column tiles, group
# widths that are not multiples of its 128-byte K slice, int8 rows whose
# width is not a multiple of 16 bytes.
INT8_CASES = {
    "gemm_acc_ragged": (1, 1, (1, 25, 41, 48), 72, {"accumulators": True}),
    "gemm_fixed_probe": (1, 1, (1, 8, 128, 256), 128, {"fixed": (10, 181, 8)}),
    "gemm_dynamic_leaky": (1, 1, (2, 13, 13, 256), 128, {"sx": "dynamic", "act": "leaky"}),
    "gemm_static_int8_vector_out": (1, 1, (2, 26, 26, 128), 256,
                                    {"sx": "static", "act": "leaky", "out": "vector"}),
    "gemm_split2_leaky": (1, 1, (2, 26, 26, 384), 128, {"splits": (128, 256), "act": "leaky"}),
    "gemm_vector_sa_mish": (1, 1, (1, 20, 20, 64), 96, {"sx": "vector", "act": "mish"}),
    "conv3x3_acc": (3, 1, (2, 20, 20, 32), 64, {"accumulators": True}),
    "conv3x3_s2_acc_ragged": (3, 2, (1, 27, 33, 48), 40, {"accumulators": True}),
    "conv3x3_rgb_acc": (3, 1, (2, 32, 32, 3), 16, {"accumulators": True}),
    "conv3x3_c24_static_mish": (3, 1, (1, 16, 16, 24), 32, {"sx": "static", "act": "mish"}),
    "conv3x3_s2_dynamic_leaky": (3, 2, (2, 26, 26, 64), 128, {"sx": "dynamic", "act": "leaky"}),
    "conv3x3_static_logistic": (3, 1, (1, 13, 13, 64), 64, {"sx": "static", "act": "logistic"}),
    "conv3x3_static_relu": (3, 1, (1, 13, 13, 64), 64, {"sx": "static", "act": "relu"}),
    "conv3x3_static_linear": (3, 1, (1, 13, 13, 64), 64, {"sx": "static", "act": "linear"}),
    "conv3x3_vector_sa_leaky": (3, 1, (2, 13, 13, 128), 128, {"sx": "vector", "act": "leaky"}),
    "conv3x3_int8_out_scalar_leaky": (3, 1, (2, 26, 26, 64), 128,
                                      {"sx": "static", "act": "leaky", "out": "scalar"}),
    "conv3x3_int8_out_vector_mish": (3, 1, (2, 13, 13, 64), 96,
                                     {"sx": "static", "act": "mish", "out": "vector"}),
    "conv3x3_split2_mish": (3, 1, (2, 13, 13, 384), 64, {"splits": (256, 128), "act": "mish"}),
    "conv3x3_split3_int8_out": (3, 1, (1, 13, 13, 128), 64,
                                {"splits": (32, 64, 32), "act": "leaky", "out": "scalar"}),
    "gemm_ragged_m_tiles_wrap_sms_acc": (1, 1, (2, 97, 89, 64), 128, {"accumulators": True}),
    "conv3x3_ragged_m_tiles_wrap_sms_leaky": (3, 1, (2, 100, 93, 32), 64,
                                              {"sx": "static", "act": "leaky"}),
    "gemm_o1024_bn256_leaky": (1, 1, (1, 13, 13, 512), 1024, {"sx": "static", "act": "leaky"}),
    "conv3x3_o1024_bn256_acc": (3, 1, (1, 13, 13, 64), 1024, {"accumulators": True}),
    "gemm_o16_mish": (1, 1, (1, 20, 20, 64), 16, {"sx": "static", "act": "mish"}),
    "conv3x3_o16_int8_out_scalar": (3, 1, (1, 16, 16, 32), 16,
                                    {"sx": "static", "act": "leaky", "out": "scalar"}),
    "gemm_split2_not_bk_widths_leaky": (1, 1, (2, 26, 26, 256), 128,
                                        {"splits": (80, 176), "act": "leaky"}),
    "gemm_split3_not_bk_widths_int8_out": (1, 1, (1, 26, 26, 256), 72,
                                           {"splits": (48, 96, 112), "act": "leaky",
                                            "out": "vector"}),
    "conv3x3_s2_ragged_out_leaky": (3, 2, (1, 27, 33, 48), 72, {"sx": "static", "act": "leaky"}),
    "conv3x3_int8_out_o40_not_16": (3, 1, (1, 13, 13, 64), 40,
                                    {"sx": "static", "act": "leaky", "out": "scalar"}),
    "gemm_int8_out_o72_not_16_vector": (1, 1, (1, 13, 13, 128), 72,
                                        {"sx": "static", "act": "logistic", "out": "vector"}),
    "gemm_k24_byte_path_leaky": (1, 1, (1, 16, 16, 24), 32, {"sx": "static", "act": "leaky"}),
    # yolov4's conv 114 after the SPP route: four 512-channel split groups
    "gemm_split4_mish_spp_19sq_2048_512": (1, 1, (1, 19, 19, 2048), 512,
                                           {"splits": (512, 512, 512, 512), "act": "mish"}),
    # yolov4x-mish@640's stride-8 stage, C = 160 (160 % 64 = 32), and its
    # CSP concats there: two 160-channel split groups
    "gemm_c160_static_mish_80sq": (1, 1, (2, 80, 80, 160), 160, {"sx": "static", "act": "mish"}),
    "conv3x3_c160_int8_out_mish_80sq": (3, 1, (1, 80, 80, 160), 160,
                                        {"sx": "static", "act": "mish", "out": "scalar"}),
    "conv3x3_s2_c160_dynamic_mish": (3, 2, (1, 80, 80, 160), 320,
                                     {"sx": "dynamic", "act": "mish"}),
    "gemm_split2_160_160_mish_80sq": (1, 1, (2, 80, 80, 320), 160,
                                      {"splits": (160, 160), "act": "mish"}),
    "gemm_split2_160_160_int8_out": (1, 1, (1, 80, 80, 320), 160,
                                     {"splits": (160, 160), "act": "mish", "out": "vector"}),
    # yolov4-p7@1536's widths that are not multiples of the 128-byte K slice
    # (480 % 128 = 96, 960 and 1600 % 128 = 64) at their grids, and its
    # CSP and PAN concats as split groups: 480 + 480 and 960 + 640
    "gemm_c480_static_mish_48sq": (1, 1, (1, 48, 48, 480), 480, {"sx": "static", "act": "mish"}),
    "conv3x3_c480_static_mish_48sq": (3, 1, (1, 48, 48, 480), 480,
                                      {"sx": "static", "act": "mish"}),
    "gemm_c960_static_mish_24sq": (1, 1, (1, 24, 24, 960), 480, {"sx": "static", "act": "mish"}),
    "conv3x3_c960_static_mish_24sq": (3, 1, (1, 24, 24, 960), 960,
                                      {"sx": "static", "act": "mish"}),
    "conv3x3_s2_c960_static_mish_48sq": (3, 2, (1, 48, 48, 960), 1280,
                                         {"sx": "static", "act": "mish"}),
    "gemm_c1600_static_mish_24sq": (1, 1, (1, 24, 24, 1600), 960,
                                    {"sx": "static", "act": "mish"}),
    "conv3x3_c1600_static_mish_12sq": (3, 1, (1, 12, 12, 1600), 640,
                                       {"sx": "static", "act": "mish"}),
    "gemm_split2_480_480_mish_48sq": (1, 1, (1, 48, 48, 960), 960,
                                      {"splits": (480, 480), "act": "mish"}),
    "gemm_split2_960_640_mish_24sq": (1, 1, (1, 24, 24, 1600), 960,
                                      {"splits": (960, 640), "act": "mish"}),
    "conv3x3_split2_960_640_mish_12sq": (3, 1, (1, 12, 12, 1600), 640,
                                         {"splits": (960, 640), "act": "mish"}),
    # the v2 ladders' int8 RGB stems at stride 1 and yolov4-tiny's at stride
    # 2 (C = 3: igemm_plan sends them to K4's packed route, whose counter
    # the planned case's launch must raise), int8 out at the next conv's
    # scale as their chain writes it
    "conv3x3_rgb_stem_s1_416sq_3_32_int8_out": (3, 1, (2, 416, 416, 3), 32,
                                                {"sx": "static", "act": "leaky",
                                                 "out": "scalar"}),
    "conv3x3_rgb_stem_s1_416sq_3_16_int8_out": (3, 1, (2, 416, 416, 3), 16,
                                                {"sx": "static", "act": "leaky",
                                                 "out": "scalar"}),
    "conv3x3_rgb_stem_s2_416sq_3_32_int8_out": (3, 2, (2, 416, 416, 3), 32,
                                                {"sx": "static", "act": "leaky",
                                                 "out": "scalar"}),
    # the packed route's edges: O = 8 and 24, batch 1 at odd 417 x 415 (a
    # tile ends in each row's middle, and the last one past M), stride 2 on
    # odd sides (the last tap past the image), tiles crossing small images,
    # every epilogue mode: int32 sums, fp32 out, int8 out at a scalar and a
    # per-channel out_scale; static, dynamic and per-channel sx; leaky,
    # mish, logistic and linear
    "conv3x3_rgb_stem_o8_fp32_out_leaky": (3, 1, (2, 64, 64, 3), 8,
                                           {"sx": "static", "act": "leaky"}),
    "conv3x3_rgb_stem_o24_int8_out_vector": (3, 1, (3, 37, 41, 3), 24,
                                             {"sx": "static", "act": "leaky", "out": "vector"}),
    "conv3x3_rgb_stem_batch1_417x415_dynamic_fp32_out": (3, 1, (1, 417, 415, 3), 32,
                                                         {"sx": "dynamic", "act": "leaky"}),
    "conv3x3_rgb_stem_s2_417x415_mish_int8_out": (3, 2, (1, 417, 415, 3), 16,
                                                  {"sx": "static", "act": "mish",
                                                   "out": "scalar"}),
    "conv3x3_rgb_stem_s2_vector_sx_logistic": (3, 2, (2, 33, 35, 3), 32,
                                               {"sx": "vector", "act": "logistic"}),
    "conv3x3_rgb_stem_small_images_linear": (3, 1, (9, 7, 5, 3), 16,
                                             {"sx": "static", "act": "linear"}),
    "conv3x3_rgb_stem_accumulators": (3, 1, (2, 29, 31, 3), 32, {"accumulators": True}),
    # yolov2's conv 29 after route 28 (the reorg's 256 channels + conv 24's
    # 1024) on split groups, and the same groups on a 1x1 conv
    "conv3x3_split2_256_1024_leaky_13sq": (3, 1, (2, 13, 13, 1280), 1024,
                                           {"splits": (256, 1024), "act": "leaky"}),
    "gemm_split2_256_1024_leaky_13sq": (1, 1, (2, 13, 13, 1280), 1024,
                                        {"splits": (256, 1024), "act": "leaky"}),
}


def int8_core_key(name, core="planned"):
    """The LAUNCHES key of the core that ``igemm_plan`` picks for a case
    (``core="mma"``: of the ``mma.sync`` core, which ``_mma=True`` forces)."""
    k, stride, shape, o, epi = (INT8_CASES.get(name) or SHORTCUT_CASES[name])[:5]
    c = shape[-1]
    splits = epi.get("splits", (c,))
    goff = [0, *np.cumsum(splits).tolist()]
    base = "int8_gemm" if k == 1 else "int8_conv"
    if core == "mma":
        return base + "_mma"
    plan, _ = tk.igemm_plan(c, goff, o, "splits" in epi, True, k, k, stride, k // 2,
                            name in SHORTCUT_CASES)
    return {"wgmma": base, "packed": base + "_packed", "mma": base + "_mma"}[plan]


# K3/K4 with a [shortcut] operand in the fp32 epilogue: name -> (kernel
# size, stride, NHWC input shape, output channels, epilogue, operand dtype).
# Both cores, leaky and mish, fp32 and bf16 operands, 256-column tiles, a
# split conv, output rows that are not whole 16-byte pieces (O = 42, 18)
# and the byte path.
SHORTCUT_CASES = {
    "gemm_dynamic_leaky_fp32": (1, 1, (2, 13, 13, 256), 128, {"sx": "dynamic", "act": "leaky"},
                                "float32"),
    "gemm_static_mish_bf16_bn256": (1, 1, (2, 26, 26, 128), 256,
                                    {"sx": "static", "act": "mish"}, "bfloat16"),
    "gemm_static_leaky_fp32_o18": (1, 1, (1, 20, 20, 64), 18, {"sx": "static", "act": "leaky"},
                                   "float32"),
    "conv3x3_static_leaky_bf16": (3, 1, (2, 26, 26, 64), 128, {"sx": "static", "act": "leaky"},
                                  "bfloat16"),
    "conv3x3_s2_mish_bf16_o42": (3, 2, (1, 27, 33, 48), 42, {"sx": "static", "act": "mish"},
                                 "bfloat16"),
    "conv3x3_split2_mish_fp32": (3, 1, (2, 13, 13, 384), 64, {"splits": (256, 128),
                                                              "act": "mish"}, "float32"),
    "gemm_c24_byte_path_leaky_bf16": (1, 1, (1, 16, 16, 24), 32,
                                      {"sx": "static", "act": "leaky"}, "bfloat16"),
}


def int8_case(name, device="cpu", case=None):
    """(xq, wq, stride, pad, epilogue kwargs) of an INT8_CASES entry (or of
    ``case``, such an entry's tuple) as tensors on ``device``; the input
    scales put the fp32 outputs near unit scale, and int8 outputs both
    round and clip."""
    k, stride, shape, o, epi = case or INT8_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    c = shape[-1]
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a)).to(dt).to(device)  # noqa: E731
    wq = t(rng.integers(-127, 128, (o, k, k, c)), torch.int8)
    if "accumulators" in epi or "fixed" in epi:
        return t(rng.integers(-127, 128, shape), torch.int8), wq, stride, k // 2, dict(epi)
    xf = t(rng.normal(0.0, 1.0, shape))
    kw = {"activation": epi["act"], "b": t(rng.normal(0.0, 0.5, o))}
    if "splits" in epi:
        sxg = t(rng.uniform(0.02, 0.04, len(epi["splits"])))
        parts, off = [], 0
        for g, cg in enumerate(epi["splits"]):
            parts.append(tk.quantize_i8(xf[..., off:off + cg], sxg[g]))
            off += cg
        xq, sx_val = torch.cat(parts, -1), 0.03
        kw.update(sxg=sxg, splits=epi["splits"])
    else:
        sx = {"dynamic": lambda: dynamic_scale(xf),
              "static": lambda: t(0.025),
              "vector": lambda: t(rng.uniform(0.01, 0.04, c))}[epi["sx"]]()
        xq = tk.quantize_i8(xf, sx)
        sx_val = 1.0 if sx.dim() == 1 else float(sx)
        kw["sx"] = sx
    acc_std = np.sqrt(k * k * c) * 35.0 * 73.0  # |xq| ~ 35, |wq| ~ 73 rms
    kw["ws"] = t(rng.uniform(0.5, 1.5, o) * 1.5 / acc_std / sx_val)
    if "out" in epi:
        kw["out_scale"] = (t(0.012) if epi["out"] == "scalar"
                           else t(rng.uniform(0.008, 0.016, o)))
    return xq, wq, stride, k // 2, kw


def shortcut_case(name, device="cpu"):
    """A SHORTCUT_CASES entry: (xq, wq, stride, pad, epilogue kwargs with
    its ``shortcut``), the operand normal at unit scale like the output."""
    *case, sdtype = SHORTCUT_CASES[name]
    xq, wq, stride, pad, kw = int8_case(name, device, tuple(case))
    n, h, w, _ = xq.shape
    ho, wo = (h + 2 * pad - wq.shape[1]) // stride + 1, (w + 2 * pad - wq.shape[2]) // stride + 1
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    sc = torch.from_numpy(rng.normal(0.0, 1.0, (n, ho, wo, wq.shape[0])).astype(np.float32))
    kw["shortcut"] = sc.to(getattr(torch, sdtype)).to(device)
    if wq.shape[1] == 1 and stride == 1:
        kw["shortcut"] = kw["shortcut"].reshape(n * ho * wo, -1)
    return xq, wq, stride, pad, kw


def run_int8_case(name, xq, wq, stride, pad, kw, plain=False, mma=False):
    """Run one INT8_CASES (or SHORTCUT_CASES) entry through K3/K4 (or their
    plain versions; ``mma`` forces the ``mma.sync`` core)."""
    core = {} if plain else {"_mma": mma}
    if wq.shape[1] == 1 and stride == 1:
        n, h, w, c = xq.shape
        fn = tk.gemm_i8_ref if plain else tk.int8_gemm
        return fn(xq.reshape(-1, c), wq.reshape(wq.shape[0], c), **core, **kw).reshape(
            n, h, w, -1)
    fn = tk.int8_conv_ref if plain else tk.int8_conv
    return fn(xq, wq, stride, pad, **core, **kw)


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_cuda_decode_score_matches_plain(cuda, name):
    _, anchors, stride, classes, kw, _, _ = DECODE_CASES[name]
    raw = torch.from_numpy(decode_input(name)).to(cuda)
    before = dict(tk.LAUNCHES)
    ours = tk.decode_score_head(raw, anchors, stride, classes, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {**before, "decode_score": before["decode_score"] + 1}
    assert_rows_close(ours.cpu().numpy(),
                      tk.decode_score_head_ref(raw, anchors, stride, classes, **kw).cpu().numpy(),
                      rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_cuda_decode_score_bf16_heads(cuda, name):
    """bf16 heads are widened in registers: the rows equal those of their
    fp32 widening."""
    _, anchors, stride, classes, kw, _, _ = DECODE_CASES[name]
    raw = torch.from_numpy(decode_input(name)).to(torch.bfloat16).to(cuda)
    wide = raw.to(torch.float32)
    ours = tk.decode_score_head(raw, anchors, stride, classes, **kw)
    assert torch.equal(ours, tk.decode_score_head(wide, anchors, stride, classes, **kw))
    assert_rows_close(ours.cpu().numpy(),
                      tk.decode_score_head_ref(raw, anchors, stride, classes, **kw).cpu().numpy(),
                      rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_decode_score_misaligned_head_raises(cuda):
    """The bulk copy needs 16-byte aligned heads; the wrapper raises, it
    does not copy."""
    buf = torch.zeros(2 * 13 * 13 * 255 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tk.decode_score_head(buf[1:].view(2, 13, 13, 255), ANCHORS, 32, 80)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,class_wise", NMS_CARD_CASES)
def test_cuda_nms_keep_matches_plain(cuda, seed, k, class_wise):
    boxes, valid, cls = (torch.from_numpy(a).to(cuda) for a in nms_input(seed, 8, k))
    c = cls if class_wise else None
    before = tk.LAUNCHES["nms_keep"]
    ours = tk.nms_keep(boxes, valid, 0.45, c)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["nms_keep"] == before + 1
    np.testing.assert_array_equal(ours.cpu().numpy(),
                                  tk.nms_keep_ref(boxes, valid, 0.45, c).cpu().numpy())


@pytest.mark.cuda
def test_cuda_decode_score_all_writes_every_row(cuda):
    """K1 over the three yolov3@416 heads into one preallocated (N, D, 8)."""
    spec = pt.Detector.load("yolov3", device="cpu").spec
    rng = np.random.default_rng(11)
    heads = tuple(torch.from_numpy(rng.normal(0, 1, (2, g, g, 255)).astype(np.float32)).to(cuda)
                  for g in (13, 26, 52))
    ours = tk.decode_score_all(heads, spec)
    ref = tk.decode_score_all(tuple(h.cpu() for h in heads), spec)
    assert tuple(ours.shape) == (2, 10647, 8)
    assert_rows_close(ours.cpu().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_score_all_is_one_launch(cuda, dtype):
    """Every head in one launch, ragged last tiles included (batch 3: 1521,
    6084 and 24336 rows, none a multiple of the 128-row tile, the first two
    not of 8 either), equal to one launch a head on their fp32 widening."""
    spec = pt.Detector.load("yolov3", device="cpu").spec
    rng = np.random.default_rng(12)
    heads = tuple(torch.from_numpy(rng.normal(0, 2, (3, g, g, 255)).astype(np.float32))
                  .to(dtype).to(cuda) for g in (13, 26, 52))
    before = dict(tk.LAUNCHES)
    ours = tk.decode_score_all(heads, spec)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {**before, "decode_score": before["decode_score"] + 1}
    for h, p in zip(heads, tk.decode_plan(heads, spec)):
        one = tk.decode_score_head(h.float(), p.anchors, p.stride, p.classes, cls_act=p.cls_act,
                                   scale_xy=p.scale_xy, new_coords=p.new_coords)
        assert torch.equal(ours[:, p.out_row0:p.out_row0 + p.rows], one)
    assert tk.LAUNCHES["decode_score"] == before["decode_score"] + 4


@pytest.mark.cuda
def test_cuda_detector_matches_cpu(cuda):
    """The slice on the card (fp32, no TF32) agrees with the port on the CPU
    and goes through both kernels."""
    frames = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
    ref = pt.Detector.load("yolov3-tiny", device="cpu").detect_batch(frames, size=416)
    before = dict(tk.LAUNCHES)
    ours = pt.Detector.load("yolov3-tiny", device=cuda).detect_batch(frames, size=416)
    assert tk.LAUNCHES["decode_score"] == before["decode_score"] + 1  # both heads, one launch
    assert tk.LAUNCHES["nms_keep"] == before["nms_keep"] + 1
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    assert stats.box_p99_px <= 1e-2, stats.row()
    for a, b in zip(ref, ours):  # near-equal ranks may trade places: compare as sets
        np.testing.assert_array_equal(np.sort(a.cls_id), np.sort(b.cls_id))


@pytest.mark.cuda
@pytest.mark.parametrize("core", ["planned", "mma"])
@pytest.mark.parametrize("name", list(INT8_CASES))
def test_cuda_int8_kernels_match_plain(cuda, name, core):
    """Each case on the core ``igemm_plan`` picks (the wgmma core unless C
    or a group offset is not a multiple of 16; the RGB stem's packed route)
    and forced onto the ``mma.sync`` core; the launch goes to the counter of
    the core that ran."""
    xq, wq, stride, pad, kw = int8_case(name, cuda)
    key = int8_core_key(name, core)
    before = dict(tk.LAUNCHES)
    ours = run_int8_case(name, xq, wq, stride, pad, kw, mma=core == "mma")
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {**before, key: before[key] + 1}
    ref = run_int8_case(name, xq, wq, stride, pad, kw, plain=True)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    if ref.dtype == torch.float32:
        np.testing.assert_allclose(ours.cpu().numpy(), ref.cpu().numpy(), rtol=1e-6, atol=1e-12)
    else:
        np.testing.assert_array_equal(ours.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("size,stride,hw", [(2, 2, 52), (2, 1, 13), (3, 1, 15), (2, 2, 416),
                                            (2, 2, 208)])
def test_cuda_int8_maxpool(cuda, size, stride, hw):
    """int8 maxpool on the card equals the fp32 pool of the same values (the
    v2 ladders' pools on resident int8: 2x2 s2 at 416² and 208², the 2x2 s1
    pool at 13²)."""
    x = torch.from_numpy(np.random.default_rng(size).integers(-127, 128, (2, 64, hw, hw))
                         .astype(np.int8)).contiguous(memory_format=torch.channels_last)
    spec = MaxPoolSpec(index=0, size=size, stride=stride)
    ours = _maxpool(x.to(cuda), spec)
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.cpu().numpy(),
                                  _maxpool(x.float(), spec).to(torch.int8).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("core", ["planned", "mma"])
@pytest.mark.parametrize("name", list(SHORTCUT_CASES))
def test_cuda_int8_shortcut_epilogue_matches_plain(cuda, name, core):
    """K3/K4 adding a [shortcut] operand after the activation, on the core
    ``igemm_plan`` picks and on the ``mma.sync`` core."""
    xq, wq, stride, pad, kw = shortcut_case(name, cuda)
    key = int8_core_key(name, core)
    before = dict(tk.LAUNCHES)
    ours = run_int8_case(name, xq, wq, stride, pad, kw, mma=core == "mma")
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {**before, key: before[key] + 1}
    ref = run_int8_case(name, xq, wq, stride, pad, kw, plain=True)
    assert ours.dtype == ref.dtype == torch.float32 and ours.shape == ref.shape
    sc = kw["shortcut"].float().reshape(ref.shape)
    gap = (ours - ref).abs()
    assert bool((gap <= 1e-6 * torch.maximum(ref.abs(), sc.abs())).all()), float(gap.max())
    assert not torch.equal(ref, run_int8_case(name, xq, wq, stride, pad,
                                              {**kw, "shortcut": None}, plain=True))


# K6 cases: name -> (NHWC shape, dtype, scale, view).  scale: "scalar" (a
# power of two), "vector" (per channel, powers of two and others) or a split
# concat's branch widths (the branches passed as channel slices of the
# concat, each at its own scale); view: None, "offset" (contiguous, 4 bytes
# off the 16-byte grid) or "slice" (the upper half of twice the channels, as
# a group route gives).  Every case has exact ties at (k + 0.5) * s and
# values past +-127.5 * s; the element counts of the C = 3 and C = 24 cases
# leave a ragged tail past the last 16-element vector.
QUANT_CASES = {
    "fp32_scalar": ((2, 13, 13, 64), "float32", "scalar", None),
    "bf16_scalar": ((2, 13, 13, 64), "bfloat16", "scalar", None),
    "fp32_vector": ((2, 13, 13, 96), "float32", "vector", None),
    "bf16_vector": ((2, 13, 13, 96), "bfloat16", "vector", None),
    "fp32_split": ((2, 26, 26, 384), "float32", (128, 256), None),
    "bf16_split3": ((1, 13, 13, 96), "bfloat16", (32, 48, 16), None),
    "fp32_c3_ragged_tail": ((1, 5, 7, 3), "float32", "scalar", None),
    "bf16_c24_vector_ragged_tail": ((3, 5, 5, 24), "bfloat16", "vector", None),
    "fp32_offset_view": ((2, 9, 9, 40), "float32", "scalar", "offset"),
    "bf16_channel_slice": ((2, 13, 13, 32), "bfloat16", "vector", "slice"),
    # yolov4-tiny's split route 3: the second half of conv 2's 64 channels
    "fp32_split_route_slice": ((2, 104, 104, 32), "float32", "scalar", "slice"),
}


def division_traps(s, n=7):
    """Up to ``n`` fp32 values within 3 ulps of (k + 0.5) * s for which
    round(x / s) and round(x * (1 / s)) differ: a quantizer that multiplies
    by the reciprocal instead of dividing gets them wrong."""
    s = np.float32(s)
    base = ((np.arange(-130, 130) + 0.5) * np.float64(s)).astype(np.float32)
    cand = (base.view(np.int32)[:, None] + np.arange(-3, 4, dtype=np.int32)).view(np.float32)
    cand = cand.ravel()
    return cand[np.rint(cand / s) != np.rint(cand * (np.float32(1) / s))][:n]


def plant_division_traps(x, per_ch):
    """Write each channel's :func:`division_traps` into the last rows of
    the fp32 (..., C) array ``x``, for every channel whose scale is not a
    power of two; returns how many were planted."""
    rows = x.reshape(-1, x.shape[-1])
    planted = 0
    for c, sc in enumerate(per_ch):
        if np.log2(sc) % 1:
            t = division_traps(sc, min(7, rows.shape[0]))
            rows[rows.shape[0] - len(t):, c] = t
            planted += len(t)
    return planted


def quantize_case(name, device="cpu"):
    """(x, sx) of a QUANT_CASES entry on ``device``; the fp32 cases carry
    :func:`division_traps` where a scale is not a power of two.  A split
    case's ``sx`` is a list of one 0-d scale a branch."""
    shape, dtype, scale, view = QUANT_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    c = shape[-1]
    if scale == "scalar":
        per_ch = np.full(c, 2.0 ** -5, np.float32)
    elif scale == "vector":
        per_ch = (2.0 ** rng.integers(-7, -3, c)).astype(np.float32)
        per_ch[::3] = rng.uniform(0.01, 0.05, per_ch[::3].shape)
    else:
        sxg = np.array([2.0 ** -6, 0.0371, 2.0 ** -4][:len(scale)], np.float32)
        per_ch = np.repeat(sxg, scale)
    x = (rng.normal(0.0, 1.5, shape) * 64 * per_ch).reshape(-1, c)
    tie = rng.uniform(size=x.shape) < 0.2
    x[tie] = ((rng.integers(-130, 130, x.shape) + 0.5) * per_ch)[tie]
    sat = rng.uniform(size=x.shape) < 0.05
    x[sat] = (rng.choice([-1.0, 1.0], x.shape) * rng.uniform(127.5, 400.0, x.shape) * per_ch)[sat]
    x = x.astype(np.float32)
    if dtype == "float32":
        plant_division_traps(x, per_ch)
    x = torch.from_numpy(x.reshape(shape)).to(device, getattr(torch, dtype))
    if view == "offset":
        buf = torch.zeros(x.numel() + 1, dtype=x.dtype, device=device)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
    elif view == "slice":
        x = torch.cat([torch.zeros_like(x), x], -1)[..., c:]
    if scale == "scalar":
        sx = torch.tensor(per_ch[0])
    elif scale == "vector":
        sx = torch.from_numpy(per_ch)
    else:
        return x, [torch.tensor(v, device=device) for v in sxg]
    return x, sx.to(device)


def channel_slices(name, x, sx):
    """A QUANT_CASES input as K6 takes it: a split case's channel slices of
    the concat (each read in place at its row stride), else ``x``."""
    widths = QUANT_CASES[name][2]
    if not isinstance(widths, tuple):
        return x
    offs = np.cumsum((0,) + widths)
    return [x[..., o:o + c] for o, c in zip(offs, widths)]


def channel_scale(name, sx):
    """``sx`` as one scale a channel (a split case's branch scales repeated
    over their widths), for comparisons on the whole tensor."""
    widths = QUANT_CASES[name][2]
    if not isinstance(widths, tuple):
        return sx
    return torch.cat([s.reshape(1).expand(c) for s, c in zip(sx, widths)])


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(QUANT_CASES))
def test_cuda_quantize_i8_matches_plain(cuda, name):
    """K6's quantizer against its plain version: int8 equal, one launch."""
    x, sx = quantize_case(name, cuda)
    if name == "fp32_offset_view":
        assert x.data_ptr() % 16 and x.is_contiguous()
    if QUANT_CASES[name][3] == "slice":
        assert not x.is_contiguous()
    xs = channel_slices(name, x, sx)
    before = dict(tk.LAUNCHES)
    ours = tk.quantize_i8(xs, sx)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {**before, "quantize_i8": before["quantize_i8"] + 1}
    ref = tk.quantize_i8_ref(xs, sx)
    assert ours.dtype == torch.int8 and ours.shape == x.shape and ours.is_contiguous()
    np.testing.assert_array_equal(ours.cpu().numpy(), ref.cpu().numpy())
    sc = channel_scale(name, sx)
    np.testing.assert_array_equal(ref.cpu().numpy(), tk.quantize_i8_ref(x, sc).cpu().numpy())
    q = (x.float() / sc).reshape(-1)
    assert bool((q.frac().abs() == 0.5).any()) and bool((q.abs() > 127.5).any())
    if name in ("fp32_vector", "fp32_split"):  # a reciprocal would round some elsewhere
        assert not torch.equal(ref, torch.clamp(torch.round(x * (1.0 / sc)), -127, 127).to(
            torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(QUANT_CASES))
def test_cuda_absmax_matches_plain(cuda, name):
    """K6's max|x| against its plain version, bit for bit, with the
    largest magnitude negative; a channels_last NCHW view (not contiguous)
    is read in place, in its memory order; a split case's channel slices
    are read as branches.  The scale the same launch writes equals
    ``scale_of_amax`` of the plain max."""
    x, sx = quantize_case(name, cuda)
    peak = 2.0 * float(x.float().abs().amax())
    x[(0,) * x.dim()] = -peak
    xs = channel_slices(name, x, sx)
    if name == "fp32_scalar":
        xs = x.permute(0, 3, 1, 2)  # NHWC bytes, NCHW view
    before = dict(tk.LAUNCHES)
    ours = tk.absmax(xs)
    scale = tk.absmax(xs, scale=True)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {**before, "absmax": before["absmax"] + 2}
    assert ours.dtype == torch.float32 and ours.dim() == 0
    assert ours.item() == tk.absmax_ref(xs).item() == peak
    assert torch.equal(scale, scale_of_amax(tk.absmax_ref(xs)))


# a route's sources handed to K6 (the read-through): name -> (leading
# shape, (width, dtype) a branch, scales: "shared" (one 0-d scale),
# "split" (one a branch) or "dynamic" (the scale from absmax over the
# branches)); ragged widths, mixed dtypes, yolov3's two concats
BRANCH_CASES = {
    "24+40_fp32_bf16_split": ((2, 13, 13), ((24, "float32"), (40, "bfloat16")), "split"),
    "24+40_bf16_bf16_shared": ((2, 13, 13), ((24, "bfloat16"), (40, "bfloat16")), "shared"),
    "128+256_bf16_fp32_split": ((2, 52, 52), ((128, "bfloat16"), (256, "float32")), "split"),
    "256+512_fp32_fp32_dynamic": ((2, 26, 26), ((256, "float32"), (512, "float32")),
                                  "dynamic"),
    "3+5+8_fp32_bf16_fp32_split": ((1, 7, 9), ((3, "float32"), (5, "bfloat16"), (8, "float32")),
                                   "split"),
    # yolov4's SPP route 113: the three maxpools and conv 107, 512 channels each
    "4x512_fp32_spp_shared": ((2, 19, 19), ((512, "float32"),) * 4, "shared"),
    # yolov4x-mish@640's CSP-SPP route 133: four 640-channel sources, 2,560
    # channels in one launch
    "4x640_bf16_spp_shared": ((2, 20, 20), ((640, "bfloat16"),) * 4, "shared"),
    "4x640_fp32_spp_split": ((2, 20, 20), ((640, "float32"),) * 4, "split"),
    # yolov2's route 28 at 416: the [reorg] of conv 26's (64, 26, 26) output
    # (256 channels at 13², a shuffled copy) and conv 24's 1024 channels
    "256+1024_reorg_fp32_fp32_dynamic": ((2, 13, 13), ((256, "float32", "reorg"),
                                                       (1024, "float32")), "dynamic"),
    "256+1024_reorg_bf16_bf16_split": ((2, 13, 13), ((256, "bfloat16", "reorg"),
                                                     (1024, "bfloat16")), "split"),
}


def branch_case(name, device="cpu"):
    """(sources, scales) of a BRANCH_CASES entry: each source its own
    contiguous tensor, with ties, saturated values and, in fp32, division
    traps at its branch's scale; a "reorg" source is Darknet's [reorg] of a
    map of a quarter of its channels at twice its height and width."""
    lead, branches, mode = BRANCH_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    sxg = np.array([0.0371, 2.0 ** -6, 0.0219, 0.0293][:len(branches)], np.float32)
    if mode != "split":
        sxg[:] = sxg[0]
    xs = []
    for (c, dtype, *view), s in zip(branches, sxg):
        if view:  # the reorg's input: (N, 2H, 2W, C / 4)
            n, h, w = lead
            pre, c = (n, 2 * h, 2 * w), c // 4
        x = (rng.normal(0.0, 1.5, (*(pre if view else lead), c)) * 64 * s).reshape(-1, c)
        tie = rng.uniform(size=x.shape) < 0.2
        x[tie] = ((rng.integers(-130, 130, x.shape) + 0.5) * s)[tie]
        sat = rng.uniform(size=x.shape) < 0.05
        x[sat] = (rng.choice([-1.0, 1.0], x.shape) * rng.uniform(127.5, 400.0, x.shape) * s)[sat]
        x = x.astype(np.float32)
        if dtype == "float32":
            plant_division_traps(x, np.full(c, s, np.float32))
        if view:  # NCHW channels_last through the forward's reorg, back to NHWC
            t = torch.from_numpy(x.reshape(*pre, c)).to(device, getattr(torch, dtype))
            xs.append(_reorg(t.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1))
            continue
        xs.append(torch.from_numpy(x.reshape(*lead, c)).to(device, getattr(torch, dtype)))
    if mode == "split":
        return xs, [torch.tensor(s, device=device) for s in sxg]
    if mode == "shared":
        return xs, torch.tensor(sxg[0], device=device)
    return xs, None


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(BRANCH_CASES))
def test_cuda_quantize_i8_branches_match_plain(cuda, name):
    """K6 over a route's sources: one launch writes the int8 of their
    concatenation, equal to the plain version's and to K6 on the
    concatenated copy; a dynamic scale is one ``absmax`` launch over the
    branches, equal to the one of the copy."""
    xs, sx = branch_case(name, cuda)
    before = dict(tk.LAUNCHES)
    if sx is None:
        sx = dynamic_scale(xs)
    ours = tk.quantize_i8(xs, sx)
    torch.cuda.synchronize()
    dyn = int(BRANCH_CASES[name][2] == "dynamic")
    assert tk.LAUNCHES == {**before, "quantize_i8": before["quantize_i8"] + 1,
                           "absmax": before["absmax"] + dyn}
    ref = tk.quantize_i8_ref(xs, sx)
    np.testing.assert_array_equal(ours.cpu().numpy(), ref.cpu().numpy())
    cat = torch.cat([t.float() for t in xs], -1)
    if isinstance(sx, list):
        sc = torch.cat([s.reshape(1).expand(t.shape[-1]) for s, t in zip(sx, xs)])
    else:
        sc = sx
        assert torch.equal(dynamic_scale(cat), sx) or not dyn
    assert torch.equal(tk.quantize_i8(cat, sc), ours)


@pytest.mark.cuda
def test_cuda_quantize_i8_every_bf16_pattern(cuda):
    """Every one of the 65,536 bf16 bit patterns (NaN and inf included),
    as a route's two sources and whole, at scales that are powers of two,
    1/127-style and neither: int8 equal to the plain version."""
    bits = torch.arange(-32768, 32768, dtype=torch.int32, device=cuda).to(torch.int16)
    x = bits.view(torch.bfloat16).reshape(64, 4, 256)
    for s in (2.0 ** -7, 1.0 / 127.0, 0.0371, 3.75, float(np.float32(5.3) / 127 + 1e-12)):
        sx = torch.tensor(s, dtype=torch.float32, device=cuda)
        ref = tk.quantize_i8_ref(x, sx)
        assert torch.equal(tk.quantize_i8(x, sx), ref)
        halves = [x[..., :128].contiguous(), x[..., 128:].contiguous()]
        assert torch.equal(tk.quantize_i8(halves, sx), ref)


@pytest.mark.cuda
def test_cuda_dynamic_scale_matches_plain(cuda):
    """The scale ``absmax`` writes, ``fma(m, 1/127, eps)``, against
    ``scale_of_amax`` of the plain max for 1,200 values of m: 0, every
    subnormal power of two and some subnormals, the powers of two, and
    values spread over the normal range."""
    rng = np.random.default_rng(3)
    ms = np.concatenate([[0.0], 2.0 ** np.arange(-149, 128),
                         rng.integers(1, 1 << 23, 100).astype(np.uint32).view(np.float32),
                         np.exp(rng.uniform(-80, 80, 822))]).astype(np.float32)
    assert len(ms) >= 1200
    for m in ms:
        x = torch.tensor([[m / 2, -m, m / 4]], dtype=torch.float32, device=cuda)
        assert torch.equal(tk.absmax(x, scale=True), scale_of_amax(tk.absmax_ref(x))), m


@pytest.mark.cuda
def test_cuda_int8_glue_runs_k6(cuda):
    """A w8a8 conv on the card quantizes through K6 alone: one
    ``quantize_i8`` launch for a bf16 or fp32 input, one ``absmax`` more
    for a dynamic scale, none for an int8-resident input."""
    from pytorch_yolo_tpu_torch.config import ConvSpec
    from pytorch_yolo_tpu_torch.ops.quant import quantized_conv

    xq, wq, _, _, kw = shortcut_case("conv3x3_static_leaky_bf16", cuda)
    spec = ConvSpec(index=1, in_channels=64, filters=128, size=3, stride=1, pad=1,
                    batch_normalize=True, activation="leaky")
    xf = torch.randn((2, 26, 26, 64), generator=torch.Generator().manual_seed(0)).to(cuda)
    for x, sx, want in ((xf, None, (1, 1)), (xf.bfloat16(), kw["sx"], (1, 0)),
                        (xq, kw["sx"], (0, 0))):
        before = dict(tk.LAUNCHES)
        y = quantized_conv(x, wq, kw["ws"], kw["b"], spec, sx=sx, shortcut=kw["shortcut"])
        torch.cuda.synchronize()
        assert (tk.LAUNCHES["quantize_i8"] - before["quantize_i8"],
                tk.LAUNCHES["absmax"] - before["absmax"]) == want
        assert tk.LAUNCHES["int8_conv"] == before["int8_conv"] + 1
        assert y.dtype == torch.float32 and tuple(y.shape) == (2, 26, 26, 128)


@pytest.mark.cuda
def test_cuda_int8_detector(cuda):
    """Detector(quant="w8a8") on the card goes through K3 and K4 and agrees
    with the CPU given the card's calibrated scales (the fp32 head convs run
    in cuDNN on the card and in oneDNN on the CPU, so not 1.0)."""
    frames = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
    before = dict(tk.LAUNCHES)
    det = pt.Detector.load("yolov3-tiny", device=cuda, quant="w8a8", quant_calib=list(frames),
                           quant_recipe="none")
    ours = det.detect_batch(frames, size=416)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["int8_gemm"] > before["int8_gemm"]
    assert tk.LAUNCHES["int8_conv"] > before["int8_conv"]
    state = det.quant_state()
    ref = pt.Detector.load("yolov3-tiny", device="cpu", quant="w8a8",
                           quant_act_scales=state["scales"],
                           quant_skip_layers=frozenset(state["skip"])).detect_batch(frames, size=416)
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement >= 0.995, stats.row()


@pytest.mark.cuda
def test_cuda_int8_detector_mixed_head_dtypes(cuda):
    """bf16 W8A8 with one head conv of two skipped: the int8 head conv gives
    fp32 and the skipped one bf16, so the forward widens both to fp32 and
    the detector serves through one K1 launch."""
    from pytorch_yolo_tpu_torch.ops.quant import head_conv_indices

    frames = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
    spec = pt.Detector.load("yolov3-tiny", device="cpu").spec
    det = pt.Detector.load("yolov3-tiny", device=cuda, dtype=torch.bfloat16, precision="default",
                           quant="w8a8", quant_calib=list(frames), quant_recipe="none",
                           quant_skip_layers={min(head_conv_indices(spec))})
    x = torch.rand((2, 96, 96, 3), generator=torch.Generator().manual_seed(0)).to(cuda)
    native, wide = det.model(x, _native_heads=True), det.model(x)
    assert [h.dtype for h in native] == [torch.float32] * 2
    for h, w in zip(native, wide):
        assert torch.equal(h, w)
    before = dict(tk.LAUNCHES)
    dets = det.detect_batch(frames, size=416)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["decode_score"] == before["decode_score"] + 1
    assert tk.LAUNCHES["int8_gemm"] > before["int8_gemm"]
    assert len(dets) == 2 and all(np.isfinite(d.boxes).all() for d in dets)


# ---------------------------------------------------------------------------
# The calibration recipe, the s2d stem and live weights on the card
# ---------------------------------------------------------------------------


def _tiny_params(seed=3):
    from pytorch_yolo_tpu_torch.weights import fold_batchnorm, random_raw_params

    spec = pt.Detector.load("yolov3-tiny", device="cpu").spec
    return spec, fold_batchnorm(spec, random_raw_params(spec, seed=seed))


@pytest.mark.cuda
def test_cuda_percentile_scales_equal_cpu(cuda):
    """Percentile ranging takes the exact order statistic on both devices:
    conv 0 (its input is the canvas itself) equal, the rest within the two
    fp32 forwards' difference (rtol 1e-5; smoothed grids 1e-4)."""
    from pytorch_yolo_tpu_torch.ops.quant import collect_act_scales

    spec, params = _tiny_params()
    x = np.random.default_rng(7).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)
    for kw, rtol in (({}, 1e-5), ({"smooth_alpha": 0.5}, 1e-4)):
        cpu = collect_act_scales(spec, params, x, percentile=99.9, device="cpu", **kw)
        gpu = collect_act_scales(spec, params, x, percentile=99.9, device=cuda, **kw)
        assert gpu.keys() == cpu.keys()
        np.testing.assert_array_equal(np.asarray(gpu[0]), np.asarray(cpu[0]))
        for i in cpu:
            np.testing.assert_allclose(np.asarray(gpu[i]), np.asarray(cpu[i]), rtol=rtol)


@pytest.mark.cuda
def test_cuda_bias_deltas_match_cpu(cuda):
    """Bias correction on the card runs each quantized twin through K3/K4
    with fp32 output; the deltas match the CPU's within 1e-2 of each
    conv's largest |delta| (an ulp in a conv's fp32 input can flip one
    int8 rounding), and the noise ranks' top 4 agree."""
    from pytorch_yolo_tpu_torch.ops import quant as tq

    spec, params = _tiny_params()
    x = np.random.default_rng(4).uniform(0, 1, (1, 256, 256, 3)).astype(np.float32)
    scales = tq.collect_act_scales(spec, params, x, percentile=99.9, smooth_alpha=0.5,
                                   device="cpu")
    qp = tq.quantize_params(spec, params, tq.resolve_skip_layers(spec, "heads"), scales)
    before = dict(tk.LAUNCHES)
    _, gpu = tq.bias_correct_params(spec, params, qp, x, device=cuda)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["int8_gemm"] > before["int8_gemm"]
    convs = ("int8_conv", "int8_conv_mma", "int8_conv_packed")
    assert sum(tk.LAUNCHES[k] for k in convs) > sum(before[k] for k in convs)
    _, cpu = tq.bias_correct_params(spec, params, qp, x, device="cpu")
    assert gpu.keys() == cpu.keys() and gpu
    for i, d in cpu.items():
        assert np.abs(gpu[i] - d).max() <= 1e-2 * np.abs(d).max(), i
    rg = tq.rank_quant_noise(spec, params, qp, x, device=cuda)
    rc = tq.rank_quant_noise(spec, params, qp, x, device="cpu")
    assert [i for i, _ in rg[:4]] == [i for i, _ in rc[:4]]


@pytest.mark.cuda
def test_cuda_s2d_forward_matches_natural(cuda):
    """yolov3 with the s2d stem on the card: at fp32 the natural stem's
    detections as a set (agreement 1.0, boxes within 1e-2 px: near-equal
    ranks may trade places); in bf16, against the fp32 reference, an
    agreement within 0.05 of the natural bf16 stem's, neither degenerate."""
    from pytorch_yolo_tpu_torch.weights import equalize_raw_params, fold_batchnorm, random_raw_params

    spec = pt.Detector.load("yolov3", device="cpu").spec
    params = fold_batchnorm(spec, equalize_raw_params(spec, random_raw_params(spec), device=cuda))
    frames = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
    ref = pt.Detector(spec, params, device=cuda).detect_batch(frames, size=416)
    fp = pt.Detector(spec, params, device=cuda, stem_s2d=True).detect_batch(frames, size=416)
    stats = detection_drift(ref, fp)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    assert stats.box_p99_px <= 1e-2, stats.row()
    agree = {}
    for s2d in (False, True):
        det = pt.Detector(spec, params, device=cuda, dtype=torch.bfloat16, precision="default",
                          stem_s2d=s2d)
        assert det.model.stem_s2d == s2d
        stats = detection_drift(ref, det.detect_batch(frames, size=416))
        assert not stats.degenerate, stats.row()
        agree[s2d] = stats.set_agreement
    assert agree[True] >= agree[False] - 0.05, agree


@pytest.mark.cuda
def test_cuda_live_detector(cuda):
    """``synthetic="live"`` on the card: the equalizer runs there and
    reaches the CPU's kernels (rtol 1e-4, same sweeps); the card's live
    detector agrees with the CPU serving the same weights (1.0) and its
    scores are not saturated."""
    from pytorch_yolo_tpu_torch.weights import equalize_raw_params, fold_batchnorm, random_raw_params

    spec = pt.Detector.load("yolov3-tiny", device="cpu").spec
    ig, ic = {}, {}
    rg = equalize_raw_params(spec, random_raw_params(spec), device=cuda, info=ig)
    rc = equalize_raw_params(spec, random_raw_params(spec), device="cpu", info=ic)
    assert ig["sweeps"] == ic["sweeps"] and ig["converged"]
    for i in rc:
        np.testing.assert_allclose(rg[i]["w"], rc[i]["w"], rtol=1e-4)
    frames = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
    det = pt.Detector.load("yolov3-tiny", device=cuda, synthetic="live")
    params = fold_batchnorm(spec, rg)
    for i, conv in det.model.convs.items():
        np.testing.assert_allclose(conv.weight.cpu().numpy(), params[int(i)]["w"], rtol=1e-6)
    ours = det.detect_batch(frames, size=416)
    ref = pt.Detector(spec, params, device="cpu").detect_batch(frames, size=416)
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    assert stats.ref_sat_frac == 0.0, stats.row()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONV_BF16_CASES))
def test_cuda_conv_bf16_matches_plain(cuda, name):
    """K5 against its plain version (an fp32 conv of the same bf16 operands,
    TF32 off): the sums' orders differ, so >= 99.9 % of outputs bit-equal
    and the rest within one bf16 step or within the order error of the
    fp32 sum (:func:`conv_bf16_floor`)."""
    x, w, b, stride, pad, act, sc = conv_bf16_input(name, cuda)
    before = tk.LAUNCHES["conv_bf16"]
    ours = tk.conv_bf16(x, w, b, stride, pad, act, sc)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["conv_bf16"] == before + 1
    ref = tk.conv_bf16_ref(x, w, b, stride, pad, act, sc)
    assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
    equal, ulps = bf16_agreement(ours, ref, conv_bf16_floor(x, w, b, stride, pad, sc))
    assert equal >= 0.999 and ulps <= 1, (equal, ulps)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CSP_CONV_CASES) + list(LARGE_CONV_CASES)
                         + list(V2_CONV_CASES) + list(BOX_CONV_CASES) + list(PAD_CONV_CASES))
def test_cuda_conv_bf16_csp_shapes(cuda, name):
    """K5 at the Scaled-YOLOv4 family's new convs (yolov4x-mish's 3->40
    stem and C = 40 / 80 convs at 640² and 320², its C = 80 1x1 conv, the
    logistic heads of both models; yolov4-p7's of
    :data:`LARGE_CONV_CASES`), at the yolov2, yolov2-tiny and yolov3-spp
    convs of :data:`V2_CONV_CASES`, at the packed and "im2col16" edges
    of :data:`BOX_CONV_CASES` and at the "im2col_pad" convs of
    :data:`PAD_CONV_CASES`, each on the route ``conv_bf16_plan`` names,
    against its plain version: the gate of
    :func:`test_cuda_conv_bf16_matches_plain`."""
    x, w, b, stride, pad, act, sc = conv_bf16_input(name, cuda)
    route = tk.conv_bf16_plan(x.shape[-1], w.shape[0], w.shape[1], w.shape[2], stride, pad)[0]
    routes = {**LARGE_CONV_CASES, **V2_CONV_CASES, **BOX_CONV_CASES, **PAD_CONV_CASES}
    assert route == (routes[name][0] if name in routes else "tma" if w.shape[1] == 1
                     else "packed" if x.shape[-1] == 3 else "im2col16")
    before = tk.LAUNCHES["conv_bf16"]
    ours = tk.conv_bf16(x, w, b, stride, pad, act, sc)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["conv_bf16"] == before + 1
    ref = tk.conv_bf16_ref(x, w, b, stride, pad, act, sc)
    assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
    equal, ulps = bf16_agreement(ours, ref, conv_bf16_floor(x, w, b, stride, pad, sc))
    assert equal >= 0.999 and ulps <= 1, (equal, ulps)


def _other_routes():
    """(case, route) pairs of :data:`BOX_CONV_CASES` for the routes the plan
    does not give: the 16-byte gather that the packed, "im2col16" and halo
    routes took these convs from (BN 64 / 128, C padded to 8), and
    "im2col16" where the plan gives the halo route; and of the "im2col_pad"
    cases of :data:`PAD_CONV_CASES` and :data:`LARGE_CONV_CASES`, the
    "im2col32" route they ran on before (32 channels a stage)."""
    pairs = []
    for name, (route, _) in BOX_CONV_CASES.items():
        if route != "gather":
            pairs.append((name, "gather"))
        if route == "halo":
            pairs.append((name, "im2col16"))
    for name, (route, _) in {**LARGE_CONV_CASES, **PAD_CONV_CASES}.items():
        if route == "im2col_pad":
            pairs.append((name, "im2col32"))
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("name,route", _other_routes())
def test_cuda_conv_bf16_other_routes(cuda, name, route):
    """The routes the plan does not give these convs (``_route``: the
    gather they left, "im2col16" for a halo conv, "im2col32" for an
    "im2col_pad" conv), still against the plain version: phase 13 of
    ``chip_smoke.py`` times them in turns with the planned ones."""
    x, w, b, stride, pad, act, sc = conv_bf16_input(name, cuda)
    ours = tk.conv_bf16(x, w, b, stride, pad, act, sc, _route=route)
    torch.cuda.synchronize()
    ref = tk.conv_bf16_ref(x, w, b, stride, pad, act, sc)
    equal, ulps = bf16_agreement(ours, ref, conv_bf16_floor(x, w, b, stride, pad, sc))
    assert equal >= 0.999 and ulps <= 1, (equal, ulps)


def _pad_tiles():
    """(case, BN) pairs of the "im2col_pad" cases of :data:`PAD_CONV_CASES`
    and :data:`LARGE_CONV_CASES` for the route's tile that the plan does not
    give the conv: 64 or 128 columns (one M-tile a CTA, B's halves
    multicast) or ``CONV_BF16_PAIR_BN`` (the cluster's CTAs on one M-tile,
    A's halves multicast)."""
    pairs = []
    for name, (route, case) in {**LARGE_CONV_CASES, **PAD_CONV_CASES}.items():
        if route == "im2col_pad":
            o, k, stride = case[4], case[5], case[6]
            bn = tk.conv_bf16_plan(case[3], o, k, k, stride, k // 2)[1]
            pairs += [(name, t) for t in (64 if o <= 64 else 128, tk.CONV_BF16_PAIR_BN) if t != bn]
    return pairs


@pytest.mark.cuda
@pytest.mark.parametrize("name,bn", _pad_tiles())
def test_cuda_conv_bf16_pad_tiles(cuda, name, bn):
    """The "im2col_pad" route at the tile its plan does not give the conv
    (``_bn``), against the plain version with the gate of
    :func:`test_cuda_conv_bf16_matches_plain`."""
    x, w, b, stride, pad, act, sc = conv_bf16_input(name, cuda)
    ours = tk.conv_bf16(x, w, b, stride, pad, act, sc, _bn=bn)
    torch.cuda.synchronize()
    ref = tk.conv_bf16_ref(x, w, b, stride, pad, act, sc)
    equal, ulps = bf16_agreement(ours, ref, conv_bf16_floor(x, w, b, stride, pad, sc))
    assert equal >= 0.999 and ulps <= 1, (equal, ulps)


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", [("yolov4-csp", 512), ("yolov4x-mish", 640),
                                       ("yolov4-p6", 1280), ("yolov4-p7", 1536)])
def test_cuda_decode_new_coords_heads_one_launch(cuda, name, size):
    """K1 on a Scaled-YOLOv4 model's new_coords heads (scale_x_y 2.0, values
    a logistic conv squashed) at its published size, bf16, in one launch:
    three heads of three anchors (the CSP pair), four or five heads of four
    anchors (p6, p7: 136,000 and 196,416 rows a frame); rows close to the
    plain version's and equal to K1's on their fp32 widening."""
    from pytorch_yolo_tpu_torch.config import head_strides
    from pytorch_yolo_tpu_torch.models.zoo import model_spec

    spec = model_spec(name)
    grids = [(len(h.mask), size // s) for h, s in zip(spec.yolo_layers, head_strides(spec))]
    rng = np.random.default_rng(size)
    heads = tuple(torch.from_numpy(rng.uniform(0, 1, (2, g, g, a * 85))
                                   .astype(np.float32)).to(torch.bfloat16).to(cuda)
                  for a, g in grids)
    before = dict(tk.LAUNCHES)
    ours = tk.decode_score_all(heads, spec)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {**before, "decode_score": before["decode_score"] + 1}
    assert ours.shape == (2, sum(a * g * g for a, g in grids), 8)
    wide = tuple(h.float() for h in heads)
    assert torch.equal(ours, tk.decode_score_all(wide, spec))
    ref = tk.decode_score_all(tuple(h.cpu() for h in wide), spec)  # the plain version
    assert_rows_close(ours.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("name,size", [("yolov2", 416), ("yolov2-tiny", 416),
                                       ("yolov3-spp", 608)])
def test_cuda_decode_zoo_heads_one_launch(cuda, name, size):
    """K1 on the bf16 heads of yolov2 and yolov2-tiny (one [region] head:
    five anchors in grid units, a softmax over 80 classes, 845 rows a frame)
    and of yolov3-spp@608 (three [yolo] heads, 22,743 rows), batch 8, in one
    launch: rows close to the plain version's and equal to K1's on their
    fp32 widening."""
    from pytorch_yolo_tpu_torch.config import head_strides
    from pytorch_yolo_tpu_torch.models.zoo import model_spec
    from pytorch_yolo_tpu_torch.ops.decode import head_decode_args

    spec = model_spec(name)
    grids = [(len(head_decode_args(h, s)[0]), size // s)
             for h, s in zip(spec.yolo_layers, head_strides(spec))]
    rng = np.random.default_rng(size + len(grids))
    heads = tuple(torch.from_numpy(rng.normal(0, 2, (8, g, g, a * 85)).astype(np.float32))
                  .to(torch.bfloat16).to(cuda) for a, g in grids)
    before = dict(tk.LAUNCHES)
    ours = tk.decode_score_all(heads, spec)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == {**before, "decode_score": before["decode_score"] + 1}
    assert ours.shape == (8, {"yolov3-spp": 22_743}.get(name, 845), 8)
    wide = tuple(h.float() for h in heads)
    assert torch.equal(ours, tk.decode_score_all(wide, spec))
    ref = tk.decode_score_all(tuple(h.cpu() for h in wide), spec)  # the plain version
    assert_rows_close(ours.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,class_wise", NMS_LARGE_CASES)
def test_cuda_nms_keep_large_k(cuda, seed, k, class_wise):
    """K2 past K = 1024: the bitmask in global memory; equal to the plain
    version."""
    boxes, valid, cls = (torch.from_numpy(a).to(cuda) for a in nms_input(seed, 4, k))
    c = cls if class_wise else None
    ours = tk.nms_keep(boxes, valid, 0.45, c)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(ours.cpu().numpy(),
                                  tk.nms_keep_ref(boxes, valid, 0.45, c).cpu().numpy())


@pytest.mark.cuda
def test_cuda_max_det_2000(cuda):
    """``max_det=2000`` (K2 in its large-K mode) on a yolov3-tiny detector
    at fp32: the card agrees with the CPU."""
    frames = np.random.default_rng(1).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
    kw = dict(size=416, conf=0.3, iou=0.45, max_det=2000)
    ref = pt.Detector.load("yolov3-tiny", device="cpu", synthetic="live").detect_batch(frames, **kw)
    ours = pt.Detector.load("yolov3-tiny", device=cuda, synthetic="live").detect_batch(frames, **kw)
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()


@pytest.mark.cuda
def test_cuda_bf16_detector_runs_k5(cuda):
    """A bf16 detector runs every conv through K5 (one launch a conv) and no
    cuDNN conv.  Its heads follow the CPU's bf16 forward (K5's plain
    version, the same weights) within ``K5_DETECTOR_L2`` relative L2, a
    limit set between two readings of ``tools/k5_accuracy.py`` on the card
    (PERF.md): K5 against the CPU, whose fp32 sums take other orders, and
    the bf16 conv that K5 replaced (cuDNN's bf16 sum, bias and activation
    in bf16) against the CPU, which must fail it; the detections' boxes
    within 1 px at p99."""
    from tools.k5_accuracy import conv_bf16_cudnn, detector_frames, heads_rel_l2, tiny_detectors

    frames = detector_frames()
    det, cpu = tiny_detectors(cuda)
    before = tk.LAUNCHES["conv_bf16"]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        ours = det.detect_batch(frames, size=416, conf=0.3)
        torch.cuda.synchronize()
    assert tk.LAUNCHES["conv_bf16"] == before + len(det.model.convs)
    names = [e.key for e in prof.key_averages()]
    assert not [n for n in names if "cudnn" in n.lower() or "conv2d" in n.lower()
                and "conv_bf16" not in n], names
    k5 = heads_rel_l2(det, cpu, frames)
    control = heads_rel_l2(det, cpu, frames, conv=conv_bf16_cudnn)
    assert max(k5) <= K5_DETECTOR_L2 < min(control), (k5, control)
    stats = detection_drift(cpu.detect_batch(frames, size=416, conf=0.3), ours)
    assert stats.ref_dets > 0 and stats.box_p99_px <= 1.0, stats.row()


@pytest.mark.cuda
@pytest.mark.parametrize("transfer", ["f32", "u8"])
def test_cuda_prepared_path_matches_cpu(cuda, transfer):
    """detect_many on mixed source sizes (the prepared pipeline, host
    letterbox, pinned staging) and detect_stream: the card against the CPU
    at fp32."""
    rng = np.random.default_rng(3)
    imgs = [rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for h, w in ((480, 640), (300, 500), (640, 480), (416, 416), (123, 777))]
    kw = dict(size=320, conf=0.3, batch=2, transfer=transfer)
    ref = pt.Detector.load("yolov3-tiny", device="cpu", synthetic="live").detect_many(imgs, **kw)
    det = pt.Detector.load("yolov3-tiny", device=cuda, synthetic="live")
    ours = det.detect_many(imgs, **kw)
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    streamed = list(det.detect_stream(imgs, size=320, conf=0.3, host_preproc=True,
                                      transfer=transfer))
    assert detection_drift(ours, streamed).set_agreement == 1.0


# ---------------------------------------------------------------------------
# The command line, batched_nms and the native weights loader on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def tiny_weights(tmp_path):
    """yolov3-tiny's .cfg and its live synthetic weights as a .weights file."""
    from pytorch_yolo_tpu_torch import weights as tw

    cfg = str(tmp_path / "tiny.cfg")
    pt.write_cfg("yolov3-tiny", cfg)
    spec = pt.model_spec("yolov3-tiny")
    raw = tw.equalize_raw_params(spec, tw.random_raw_params(spec), device="cpu")
    path = str(tmp_path / "tiny.weights")
    tw.write_weights_file(spec, raw, path)
    return cfg, path


@pytest.mark.cuda
def test_cuda_cli_detect_bf16_matches_detect_batch(cuda, tiny_weights, tmp_path):
    """``detect --bf16`` on 4 PNG frames equals ``detect_batch`` of the same
    bf16 detector (same ids, the 2-decimal boxes within 0.01), with one K5
    launch a conv and one K1 and one K2 launch for the batch."""
    import json

    from pytorch_yolo_tpu_torch import cli
    from pytorch_yolo_tpu_torch.serve import encode_png

    cfg, weights = tiny_weights
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (4, 480, 640, 3), dtype=np.uint8)
    img_dir = tmp_path / "frames"
    img_dir.mkdir()
    for i, im in enumerate(frames):
        (img_dir / f"f{i}.png").write_bytes(encode_png(im))
    before = dict(tk.LAUNCHES)
    assert cli.main(["detect", "--cfg", cfg, "--weights", weights, "--bf16", "--images",
                     str(img_dir), "--save-json", "--det", str(tmp_path / "det"),
                     "--confidence", "0.3"]) == 0
    det = pt.Detector.load(cfg, weights, device=cuda, dtype=torch.bfloat16, precision="default")
    launched = {k: v - before[k] for k, v in tk.LAUNCHES.items()}
    assert (launched["conv_bf16"], launched["decode_score"], launched["nms_keep"]) == (
        len(det.model.convs), 1, 1), launched
    ref = det.detect_batch(frames, size=416, conf=0.3)
    rows = [json.loads(line) for line in open(tmp_path / "det" / "detections.jsonl")]
    assert sum(len(d) for d in ref) > 0
    for row, d in zip(rows, ref):
        assert row["cls_id"] == d.cls_id.tolist()
        np.testing.assert_allclose(np.asarray(row["boxes"]).reshape(-1, 4), d.boxes,
                                   rtol=0, atol=0.01 + 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("class_agnostic", [False, True])
def test_cuda_batched_nms_matches_cpu(cuda, class_agnostic):
    """batched_nms on 85-column rows: K2 on the card (one launch) equals the
    CPU's fixpoint; boxes within 1e-5."""
    from pytorch_yolo_tpu_torch.ops.nms import batched_nms

    rng = np.random.default_rng(5)
    rows = np.zeros((4, 2000, 85), np.float32)
    rows[..., :2] = rng.uniform(0, 416, (4, 2000, 2))
    rows[..., 2:4] = rng.uniform(8, 120, (4, 2000, 2))
    rows[..., 4:] = rng.choice([0.2, 0.55, 0.7, 0.9, 1.0], (4, 2000, 81))
    before = tk.LAUNCHES["nms_keep"]
    ours = batched_nms(torch.from_numpy(rows).to(cuda), 0.5, 0.45, 300,
                       class_agnostic=class_agnostic)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["nms_keep"] == before + 1
    ref = batched_nms(torch.from_numpy(rows), 0.5, 0.45, 300, class_agnostic=class_agnostic)
    assert torch.equal(ours.valid.cpu(), ref.valid) and bool(ref.valid.any())
    assert torch.equal(ours.cls_id.cpu(), ref.cls_id)
    np.testing.assert_allclose(ours.boxes.cpu().numpy(), ref.boxes.numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_cuda_native_loader_feeds_card_detector(cuda, tiny_weights):
    """load_weights(native=True) params served on the card give the heads
    of the numpy-loaded params: the loads agree within rtol 1e-6 / atol
    1e-7 (the fold's fp32 rounding), the fp32 heads within 1e-5."""
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch
    from pytorch_yolo_tpu_torch.weights import load_weights

    cfg, weights = tiny_weights
    spec = pt.load_model_spec(cfg)
    nat = load_weights(spec, weights, native=True)
    ref = load_weights(spec, weights, native=False)
    x = letterbox_batch(torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, (2, 480, 640, 3), dtype=np.uint8)).to(cuda), 416)
    for i, p in ref.items():
        for key in ("w", "b"):
            np.testing.assert_allclose(nat[i][key], p[key], rtol=1e-6, atol=1e-7)
    heads = [pt.Detector(spec, p, device=cuda).model(x) for p in (nat, ref)]
    for a, b in zip(*heads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The batch mesh on the card
# ---------------------------------------------------------------------------


def _skewed(n=8, shape=(480, 640)):
    """n frames, frame 3 over the whole range, the others dim (< 24)."""
    rng = np.random.default_rng(17)
    x = rng.integers(0, 24, (n,) + shape + (3,), dtype=np.uint8)
    x[3] = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
    return x


def _same(ref, ours):
    assert len(ref) == len(ours) and sum(len(d) for d in ref) > 0
    for a, b in zip(ref, ours):
        for f in ("boxes", "obj", "cls_score", "cls_id"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["bf16", "w8a8_dynamic"])
def test_cuda_mesh_of_two_entries_matches_single(cuda, mode):
    """A mesh of two entries of cuda:0 gives the meshless detector's
    detections bit for bit: bf16 (K5, K1, K2 a shard) and dynamic int8 with
    bf16 glue on a skewed batch, whose shards' own maxima differ at the
    first int8 conv (the scale is the whole batch's; K3/K4 a shard)."""
    from pytorch_yolo_tpu_torch.parallel import make_batch_mesh

    kw = dict(dtype=torch.bfloat16, precision="default", synthetic="live")
    if mode == "w8a8_dynamic":
        kw.update(quant="w8a8")
    single = pt.Detector.load("yolov3-tiny", device="cuda:0", **kw)
    mesh = pt.Detector.load("yolov3-tiny", mesh=make_batch_mesh(["cuda:0", "cuda:0"]), **kw)
    assert mesh.device == torch.device("cuda", 0) and mesh._replicas[1] is mesh.model
    frames = _skewed()
    ref = single.detect_batch(frames, size=416, conf=0.3)
    before = dict(tk.LAUNCHES)
    ours = mesh.detect_batch(frames, size=416, conf=0.3)
    torch.cuda.synchronize()
    ran = {k: tk.LAUNCHES[k] - before[k] for k in tk.LAUNCHES}
    assert ran["decode_score"] == ran["nms_keep"] == 2
    assert ran["conv_bf16"] == 2 * len(mesh.model.convs)
    if mode == "w8a8_dynamic":
        assert (ran["int8_gemm"] + ran["int8_conv"] + ran["int8_gemm_mma"]
                + ran["int8_conv_mma"] + ran["int8_conv_packed"]) == 2 * len(mesh.model.qconvs)
        first = min(map(int, mesh.model.qconvs))
        x = letterbox_batch(torch.from_numpy(frames).to(cuda), 416)
        local = [float(mesh.model(x[i:i + 4], collect_conv_in_stats=lambda i, v: v.abs().amax()
                                  if i == first else None)[1][first]) for i in (0, 4)]
        assert local[0] != local[1]
    _same(ref, ours)


@pytest.mark.cuda
def test_cuda_launches_keep_the_current_device(cuda):
    """K1-K5 launched on each card leave torch's current device as it was
    (each C entry restores it: ``csrc/device_guard.cuh``)."""
    rng = np.random.default_rng(5)
    count = torch.cuda.device_count()
    for target in range(count):
        dev = torch.device("cuda", target)
        for current in range(count):
            with torch.cuda.device(current):
                tk.decode_score_head(torch.from_numpy(decode_input("grid13")).to(dev), ANCHORS,
                                     32, 80)
                assert torch.cuda.current_device() == current
                boxes, valid, cls = (torch.from_numpy(a).to(dev) for a in crowded_boxes(1, 2, 300))
                tk.nms_keep(boxes, valid, 0.45, cls)
                assert torch.cuda.current_device() == current
                xq = torch.from_numpy(rng.integers(-127, 128, (2, 8, 8, 64), dtype=np.int8)).to(dev)
                wq = torch.from_numpy(rng.integers(-127, 128, (32, 3, 3, 64), dtype=np.int8)).to(dev)
                tk.int8_conv(xq, wq, 1, 1, accumulators=True)
                tk.int8_gemm(xq.reshape(-1, 64), wq[:, 0, 0].contiguous(), accumulators=True)
                assert torch.cuda.current_device() == current
                x = torch.randn(2, 8, 8, 64, device=dev).to(torch.bfloat16)
                w = torch.randn(32, 3, 3, 64, device=dev).to(torch.bfloat16)
                tk.conv_bf16(x, w, torch.zeros(32, device=dev), 1, 1, "leaky")
                assert torch.cuda.current_device() == current
        torch.cuda.synchronize(dev)


@pytest.mark.cuda
def test_cuda_stage_on_mesh_hands_each_chunk_its_data(cuda):
    """The pinned ring of a mesh detector: chunks staged back to back, with
    no sync between them, arrive on their device as they were sent (a
    slot is reused only after the copy recorded on its own stream is
    done); detect_prepared on the mesh equals the meshless one."""
    from pytorch_yolo_tpu_torch.parallel import make_batch_mesh

    det = pt.Detector.load("yolov3-tiny", mesh=make_batch_mesh(["cuda:0", "cuda:0"]))
    rng = np.random.default_rng(8)
    chunks = [rng.integers(0, 256, (4, 320, 320, 3), dtype=np.uint8) for _ in range(12)]
    staged = [det._stage(c, d) for c in chunks for d in det.mesh.devices]
    assert len(det._staging) == 1 and len(next(iter(det._staging.values()))) == 1 + 6
    torch.cuda.synchronize()
    for c, (a, b) in zip(chunks, zip(staged[::2], staged[1::2])):
        np.testing.assert_array_equal(a.cpu().numpy(), c)
        np.testing.assert_array_equal(b.cpu().numpy(), c)
    single = pt.Detector.load("yolov3-tiny", device="cuda:0")
    lbs = [letterbox_host(f, 320, out_dtype="uint8") for f in _skewed(4)]
    x = np.stack([lb for lb, _ in lbs])
    geos = np.asarray([[g.scale, g.pad_x, g.pad_y, g.orig_w, g.orig_h] for _, g in lbs],
                      np.float32)
    _same(single._trim(single.detect_prepared(x, geos, 320), 4),
          det._trim(det.detect_prepared(x, geos, 320), 4))


@pytest.fixture
def two_cards(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    return torch.device("cuda", 0), torch.device("cuda", 1)


@pytest.mark.cuda
def test_cuda_second_card_matches_first(two_cards):
    """A cuda:1 detector gives the cuda:0 detector's detections, and leaves
    the current device at cuda:0; the profiler times it on cuda:1."""
    frames = _skewed(4)
    kw = dict(dtype=torch.bfloat16, precision="default", synthetic="live")
    ref = pt.Detector.load("yolov3-tiny", device=two_cards[0], **kw).detect_batch(frames)
    with torch.cuda.device(0):
        det = pt.Detector.load("yolov3-tiny", device=two_cards[1], **kw)
        ours = det.detect_batch(frames)
        assert torch.cuda.current_device() == 0
        # the stage profiler's events on the detector's card, not the current one
        from pytorch_yolo_tpu_torch.utils.profiling import profile_pipeline

        rows = profile_pipeline(det, size=416, batch=2, iters=2)
        assert rows[-1]["cum_ms"] > 0 and torch.cuda.current_device() == 0
    _same(ref, ours)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [None, "w8a8"])
def test_cuda_mesh_over_two_cards_matches_one(two_cards, quant):
    """A mesh over cuda:0 and cuda:1 (one replica each, the results and the
    dynamic int8 scale through peer copies) equals one card."""
    from pytorch_yolo_tpu_torch.parallel import make_batch_mesh

    kw = dict(dtype=torch.bfloat16, precision="default", synthetic="live", quant=quant)
    single = pt.Detector.load("yolov3-tiny", device=two_cards[0], **kw)
    mesh = pt.Detector.load("yolov3-tiny", mesh=make_batch_mesh(list(two_cards)), **kw)
    assert mesh._replicas[1] is not mesh.model
    assert next(mesh._replicas[1].buffers()).device == two_cards[1]
    frames = _skewed()
    _same(single.detect_batch(frames, conf=0.3), mesh.detect_batch(frames, conf=0.3))
    _same(single.detect_many(list(frames), conf=0.3, batch=4, transfer="u8"),
          mesh.detect_many(list(frames), conf=0.3, batch=4, transfer="u8"))


@pytest.mark.cuda
def test_cuda_decode_grid_cache_under_two_threads(cuda):
    """K1 launched from two threads at once, each alternating heads of two
    class counts (two shared-memory sizes of one instantiation, the larger
    first in one thread and the smaller in the other): every launch goes
    and gives its plain version's rows (each device's grids sit under a
    lock, and the kernel's shared-memory allowance is only ever raised)."""
    import threading

    cases = [(torch.from_numpy(np.random.default_rng(c).normal(
        0, 1, (2, 13, 13, 3 * (5 + c))).astype(np.float32)).to(cuda), c) for c in (80, 20)]
    refs = [tk.decode_score_head_ref(raw.cpu(), ANCHORS, 32, c) for raw, c in cases]
    errors: list = []

    def run(first):
        try:
            outs = []
            for i in range(100):
                j = (first + i) % 2
                outs.append((j, tk.decode_score_head(cases[j][0], ANCHORS, 32, cases[j][1])))
            torch.cuda.current_stream(cuda).synchronize()
            for j, out in outs:
                assert_rows_close(out.cpu().numpy(), refs[j].numpy(), rtol=1e-5, atol=1e-5)
        except Exception as e:  # reported below, from the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(first,)) for first in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors

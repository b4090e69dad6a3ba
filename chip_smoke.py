#!/usr/bin/env python3
"""Drive the PyTorch port's detection main path once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the repository root, one card

Phases, one line each (a failure in any phase exits non-zero):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from ``pytorch_yolo_tpu_torch/csrc``;
  3. K1 decode+score against its plain torch version on the card, at the
     yolov3@416 head shapes (batch 8) plus a [region] softmax head, a
     4-anchor new_coords head and yolov4@608's three scale_x_y heads; the
     three yolov3 heads in bf16 in one launch, equal bit for bit to K1 on
     their fp32 widening; yolov4's three heads in bf16 in one launch; the
     three new_coords heads (scale_x_y 2.0, values in [0, 1]) of
     yolov4-csp@512 and of yolov4x-mish@640, each head alone and each
     model's three in bf16 in one launch, equal to K1 on their fp32
     widening; the same for the three, four and five 4-anchor new_coords
     heads of yolov4-p5@896, yolov4-p6@1280 and yolov4-p7@1536 (p7: grids
     192² to 12², 196,416 rows a frame); the [region] softmax heads of
     yolov2@416 and yolov2-tiny@416 (five anchors in grid units, 845 rows a
     frame) and yolov3-spp@608's three heads, each head alone in fp32 and
     each model's heads in bf16 in one launch, equal to K1 on their fp32
     widening; a misaligned head, which must raise; a class tie (the lowest
     index wins);
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
     K1 and one K2 a step, one K5 a conv: every conv of the bf16 path runs
     K5, 23 of them with their [shortcut] in the epilogue); then, at those
     shapes, K1 on the step's bf16
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
     output, int8 out with O not a multiple of 16, the byte path), and the
     int8 RGB stem on K4's packed route (the three zoo stems at 416², s1
     3 -> 32 and 3 -> 16, s2 3 -> 32; int32 sums, fp32 out, int8 out at a
     scalar and a per-channel out_scale; static, dynamic, per-channel and
     int8 sx; leaky, mish, logistic, linear; O = 8, 16, 24, 32; batch 1 at
     417 x 415 at stride 1 and 2; tiles across small images; a one-pixel
     wide image), each on the core ``igemm_plan`` picks (its launch counter
     checked) and on the ``mma.sync`` core, against their plain versions
     (int32 and int8 equal, fp32 within 1e-6 relative; the packed route
     equal in every mode); K3/K4 with a [shortcut] operand (fp32 and
     bf16, leaky and mish, ragged output rows, a split conv, the byte path)
     on both cores, within 1e-6 of the larger of the output and the
     operand; then K6, the int8 input quantizer, against its plain version
     (int8 equal: fp32 and bf16, a scalar, a per-channel and a split scale
     (the concat's channel slices, read in place), exact ties and
     saturation in every case, in fp32 values that a multiply by the
     reciprocal would round the other way, ragged tails at C = 3 and 24, an
     offset view and a channel slice) and its ``max|x|`` (bit-equal); K6
     over a route's sources (the read-through: 24 + 40, 128 + 256, 256 +
     512 and 3 + 5 + 8 channels, each source fp32 or bf16, at split, shared
     and dynamic scales): one launch, int8 equal, the dynamic scale over the
     sources equal to the concat's; every bf16 bit pattern at five scales
     (powers of two, 1/127-style and others) and every fp32 bit pattern (2^32, in chunks) at each scale, int8 equal
     to the plain version (the count a multiply by the reciprocal would get
     wrong printed); and the scale ``absmax`` writes equal to
     ``scale_of_amax`` of the plain max for 1,200 values of the max (0,
     subnormals, every power of two);
  8. yolov3-tiny@416 ``quant="w8a8"`` with fp32 glue (every non-head conv
     int8, the maxpool ladder int8-resident), static scales calibrated on
     the card from 4 frames (``quant_recipe="none"``), against the CPU
     serving the card's ``quant_state()`` (set agreement >= 0.995), one K1
     and one K2 launch;
  9. the int8 slice at full width, ``bench.py``'s ``int8sb``: yolov3@416
     w8a8 with bf16 glue, the stride-8 early skip, int8-resident chains,
     static scales from 4 frames, batch 128, the frames of phase 6 — median
     ms/batch and img/s as in phase 6, the launch counts (one K1 and one K2
     a step, one K3/K4 launch a quantized conv, one K6 launch a conv input
     that is not int8-resident, every [shortcut] after an int8 conv in its
     epilogue), the drift against phase 6's bf16 detections (printed, not
     gated); it fails if any of its int8 convs ran on the ``mma.sync`` core,
     or if ``torch.profiler`` finds an activation-sized ``aten::div``,
     ``round``, ``clamp``, an unfused shortcut ``add`` or a ``cat`` in its
     forward (the concat routes 86 and 98 are read through by their conv's
     K6).  Then int8sb with dynamic scales (one ``absmax``, which writes the
     scale, and one K6 launch a conv), median ms/batch; it fails if the
     dynamic forward runs a float64 op or a ``full_like`` (a
     TorchDispatchMode watches it); the device operations of a static and
     of a dynamic step (``torch.profiler``); K6 alone at (128, 52, 52,
     256), the largest input, fp32 and bf16, eager and device time, the
     first K6's device time (PERF.md §6) beside it, its plain version, its
     bound and ``torch.quantize_per_tensor`` (a yardstick: it rounds to
     [-128, 127]; device times in turns), per channel beside
     ``torch.quantize_per_channel``, ``absmax`` with the scale beside
     ``torch.linalg.vector_norm(x, inf)``, and the two route concats read
     through against ``torch.cat`` + K6, in turns, and against the plain
     version.  Then K3 and K4 at
     phase 7's four yolov3 shapes and the 26² 3x3 conv at batch 128: each
     against its plain version on both cores, without and with an fp32 and
     a bf16 [shortcut] operand (phase 7's gates); their times, the wgmma
     core and the
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
     CPU serving the card's ``quant_state()`` (>= 0.995).  The bf16 rows
     print beside 0.898 / 0.901 (s2d / natural stem, the card before K5)
     and 0.912 (the JAX package's CPU row);
 12. A/B at batch 128 on the live weights, phase 6's method: bf16 with the
     s2d stem off, on, on, off, and the two stems' layers timed alone;
     int8sb "none", "auto", "auto", "none"; and K2 eager and device ms on
     the live step's candidates, with its bound and the fixpoint's rounds,
     beside phase 6's;
 13. K5 (bf16 implicit-GEMM conv) against its plain version (an fp32 conv
     of the same bf16 operands, TF32 off, + fp32 bias, activation, one
     rounding) on the real activations of every distinct conv shape of
     yolov3@416 at batch 8 and of yolov4@608 at batch 4 (the bf16 live
     forwards' conv inputs), each activation and a fused shortcut: >= 99.9 %
     of outputs bit-equal and the rest within one bf16 step or the order
     error of an fp32 sum (2^-20 of sum |x w| + |b|); K5 with mish against
     leaky at yolov4's 608² stride-2 conv, batch 64, device time in turns;
     the same gate on every distinct conv of yolov4-csp@512,
     yolov4x-mish@640, yolov4-p5@896, yolov4-p6@1280 and yolov4-p7@1536 at
     batch 4 (the logistic heads, the 3->40 stems on the packed route and
     the C = 40 / 80 convs on the "im2col16" route included), and the
     distinct convs that the 16-byte gather route ran before (the 3->40
     stem and C % 32 != 0) of yolov4x-mish (layers 0, 1, 3, 5 and 10) at
     its path's batch 64 and of yolov4-p7 (layers 0, 1, 6, 11 and 16, 19,
     22) at its batch 8, eager and device time beside the bound, the plain
     version, cuDNN's bf16 ``F.conv2d`` + bf16 bias + mish (eager and
     device, in turns), the gather route (``_route="gather"``, device, in
     turns) and, for p7's conv 6 on the halo route, the "im2col16" route
     (device, in turns; its output equal to the halo route's bit for
     bit); their "im2col_pad" convs (C % 64 == 32: 160, 480; 64-channel
     boxes, 80-column tiles of one M-tile a cluster) the same way, beside
     the "im2col32" route they ran on before (``_route="im2col32"``, device,
     in turns) instead of the gather, and yolov4x-mish's 80² 160->160 conv
     with leaky against its mish, in turns; the same gate on every distinct conv of
     yolov3-spp@608, yolov2@416 and yolov2-tiny@416 at batch 4, and
     yolov2-tiny's C = 16 conv (layer 2) at batch 128, timed the same way
     beside cuDNN + bias + leaky and the gather;
     then K5 at batch 128 at every distinct
     yolov3@416 conv shape whose A does not come by a 2-D TMA box (11:
     the im2col, im2col32 and packed routes) and at the largest 1x1 (52²
     256->128), eager and device time, beside its plain version, the
     library path it replaced (cuDNN bf16 ``F.conv2d`` with its bf16 bias
     + leaky, eager and device, in turns), its bound (bf16 at 989 TFLOP/s or bytes at
     3.35 TB/s) and its launches a step; beside them, from a model of the
     shapes (``kernels.conv_bf16_traffic``, no counter), the tile loads'
     bytes and their rate, and the device time over the modelled stages of
     an SM; and yolov3's C = 32 pair (still "im2col32") at batch 128 on
     seeded inputs, its output digests equal to the parent tree's;
 14. K2 past K = 1024 (the bitmask in global memory) against its plain
     version: crowded boxes at K = 1025, 2048 and 10,647 (class-wise and
     not), a 1025-long chain, and the live bf16 detector at
     max_det = 10,647 (every candidate of yolov3@416), the launch counted;
     its time at 10,647 beside its bound, and K <= 1024 re-timed at
     128 x 300;
 15. the prepared path: yolov3-tiny live fp32 ``detect_many`` on mixed
     source sizes, f32 and u8 transfer, card against CPU (set agreement
     1.0); yolov3@416 live bf16 ``detect_many`` over 32 mixed images in
     chunks of 8 (K1/K2/K5 counted) and ``serve.make_server`` on
     127.0.0.1 answering 8 concurrent POSTs of PNGs, equal to
     ``detect_many`` on the same images (set agreement 1.0); then, each
     over 3 windows of several seconds in turns (median and spread):
     ``detect_many`` img/s over 384 images, ``detect_stream`` ms per
     frame at batch 1 over 480 frames (bf16, bf16 with the host letterbox
     and u8, int8sb), and the server's req/s and median latency with 16
     clients POSTing 384 PNGs;
 16. the command line at full width (``cli.main`` in this process, yolov3@416
     from ``cfg/yolov3.cfg`` with the live weights, 480x640 PNG frames written
     by the port's encoder): (a) ``write_weights_file``, then
     ``load_weights(native=True)`` (the C++ loader, built with g++) and
     ``native=False`` give equal folded params (rtol 1e-6, atol 1e-7), both
     load times printed; (b) ``detect --bf16 --batch 8 --save-json`` on 16
     frames equals ``detect_batch`` (same ids, boxes within 0.01), one K5 a
     conv and one K1 and one K2 a batch, every ``det_*.png`` decodes; (c)
     ``evaluate`` of the fp32 detector on a COCO set written from its own
     ``detect_many(transfer="u8")`` at 384x512 (at least 50 boxes): mAP@0.5
     and AP@[.5:.95] >= 0.999; ``--bf16`` printed beside phase 11's bf16
     drift; fp32 ``detect_many`` u8 img/s at batch 8, 16, 32 and 64 over 3
     windows in turns (``evaluate --batch``'s default is the best); (d)
     ``profile --pipeline --bf16`` and ``profile --bf16`` at batch 128:
     ``+nms`` within 15 % of phase 6's ms/batch and the stage rows' last
     ``cum_ms`` within 10 % of the ``+forward`` delta; (e) ``detect --int8
     --bf16 --int8-calib DIR --int8-scales F`` twice (calibrate and write,
     then reload): set agreement 1.0, K3/K4 launched and none on
     ``mma.sync``; (f) ``batched_nms`` on yolov3's 85-column rows (bf16
     heads, the plain decode, widened to fp32) at batch 8: one K2 launch,
     equal to the CPU's; (g) ``python -m pytorch_yolo_tpu_torch info`` and
     ``detect`` in subprocesses exit 0 without rebuilding the kernels;
 17. the batch mesh (``parallel.make_batch_mesh``, ``Detector(mesh=)``),
     each entry a shard: (a) yolov3@416 live bf16 at batch 128 on a mesh
     of two entries of cuda:0 against the same detector without a mesh on
     phase 6's frames: set agreement 1.0 (the largest box difference and
     whether the two are bit-equal printed), the result on cuda:0, and
     exactly twice the meshless step's launches; (b) yolov3-tiny live w8a8
     with dynamic scales and bf16 glue on a skewed batch (one bright frame,
     seven dim) on 2 entries: the shards' own max|x| at the first int8 conv
     printed and required to differ, the detections bit-equal to meshless
     (the scale is the whole batch's), every int8 conv on K3/K4 once a
     shard; (c) on 17a's mesh: a ragged batch (5 -> 6), ``detect_many``
     u8, ``detect_stream`` (raw and host letterbox) and a ``MicroBatcher``
     of floor 2 (``batch_max`` 3 -> 4) answering 5 concurrent requests,
     each at set agreement 1.0 with meshless; (d) bf16 ms/batch at batch
     128, meshless and mesh in turns (a reading, not a gate); (e) 17a over
     every card where there is more than one, else one line saying so.
     The current device is what it was before the phase;
 18. yolov4@608 (the published cfg's size), live weights: (a) fp32 /
     "highest" on the card (one K1 and one K2 launch) against the CPU on
     2 frames (set agreement >= 0.995, the worst matched box
     printed; CUDA's and the CPU's mish differ in their last ulps); (b)
     bf16 at batch 64 (23.7 M pixels a step), phase 6's frames and method:
     median ms/batch and img/s, one K5 launch for each of the 110 convs
     and one K1 and one K2 a step, the top ``torch.profiler`` rows by
     kernel, and SPP's three stride-1 maxpools timed alone; (d) bf16 at
     batch 128 once: every field of the result bit-equal to the two batch-64
     halves (layer 0's output is 3.03 GB), peak memory printed; (c) int8sb
     (w8a8, bf16 glue, the default early skip: 89 int8 convs, 21 on K5,
     static scales from 4 frames at 608): as (b), plus one K3/K4 launch an
     int8 conv (none on ``mma.sync``), one K6 a conv input that is not
     int8-resident, no activation-sized ``div``/``round``/``clamp``, no
     unfused [shortcut] ``add``, and no ``cat`` of a route before an int8
     conv (SPP's route 113 read through by one four-source K6), every
     K3/K4/K6 call of the forward held against its plain version, and
     again with ``quant_split_concat`` (conv 114 on four split groups), the
     drift against (b) printed; (e) drift of bf16 and int8sb "auto" against
     fp32 on 4 frames: no degenerate row;
 19. yolov4-tiny@416, live weights: fp32 card vs CPU on 4 frames (set
     agreement 1.0); bf16 (21 K5 launches a step) and int8sb (the ladder:
     early skip 0, 19 int8 convs, the stride-2 RGB stem on K4's packed
     route and none on ``mma.sync``, the int8 maxpool chain, split routes
     read as channel slices by K6) at batch 128: ms/batch, launches,
     profiler rows; the stem alone as in phase 26; int8sb on the card
     against the CPU serving the card's ``quant_state()`` (>= 0.995);
 20. yolov4-csp@512 (the Scaled-YOLOv4 CSP family: mish over the body,
     CSP routes, bias-only logistic head convs, new_coords heads), live
     weights, batch 128: as phase 18, (a) fp32 card vs CPU on 2 frames
     (>= 0.995); (b) bf16: ms/batch, img/s, one K5 launch for each of the
     115 convs and one K1 and one K2 a step, the profiler rows, the CSP-SPP
     block's three maxpools timed alone; (c) int8sb
     (default skip: 98 int8 convs, 61 on K3 and 37 on K4, none on
     ``mma.sync``; 17 on K5): the launch counts, no activation-sized
     ``div``/``round``/``clamp``, no ``cat`` of a route before an int8 conv
     (the CSP-SPP route 109 read through by one four-source K6), every
     K3/K4/K6 call of the forward held against its plain version, and
     again with ``quant_split_concat`` (13 int8 convs on split groups);
     (e) drift of bf16 and int8sb "auto" against fp32 on 4 frames: no
     degenerate row;
 21. yolov4x-mish@640 (139 convs, 6 on K5's "im2col16" route, 17 on its
     "im2col_pad" route, none on "im2col32" and the 3->40 stem on its
     packed route, checked by route), live weights,
     batch 64: as phase 20 (int8sb: 120 int8 convs, 72 on K3 and 48 on
     K4, the CSP-SPP route 133's four 640-channel sources in one K6), plus
     (d) bf16 at batch 128 once, bit-equal to its two halves (layer 0's
     output 2.10e9 elements, 97.7 % of 2^31), with the peak memory;
 22. yolov4-p5@896 (the Scaled-YOLOv4 large family: 4-anchor new_coords
     heads, CSP stages and BottleneckCSP2 necks), live weights, batch 32:
     as phase 21 (bf16: 163 K5 a step; int8sb: 82 K3 + 58 K4, 23 on K5;
     the CSP-SPP route 169 in one K6; 13 convs on split groups; (d) at
     batch 64);
 23. yolov4-p6@1280 (a stride-64 head, early skip 16), batch 16: as 22
     (205 K5; 81 K3 + 53 K4, 71 on K5; route 197; 15 split convs; (d) at
     32);
 24. yolov4-p7@1536 (a stride-128 head, early skip 32, 5 convs on K5's
     "im2col16" route, conv 6 on its halo route, 23 on "im2col_pad", the
     3->40 stem packed),
     batch 8: as 22 (247 K5; 73 K3 + 45 K4, 129 on K5; route
     225's four 640-channel sources; 15 split convs; (d) at 16);
 25. yolov3-spp@608 (SPP in a leaky Darknet-53), live weights, batch 64:
     as 18 (bf16: 76 K5 a step; int8sb: early skip 8, 32 K3 + 31 K4, 13
     on K5; SPP's route 83 in one K6; 3 split convs; (d) at 128), except
     that a degenerate drift row (this model's regime on the TPU) is
     printed DO-NOT-BANK instead of failing the phase;
 26. yolov2@416 ([reorg], the [region] softmax head), live weights, batch
     128: as 18 (bf16: 23 K5 a step; int8sb, the ladder: early skip 0, 7
     K3 + 15 K4 with the int8 RGB stem on K4's packed route and none on
     ``mma.sync``, 1 on K5, the int8 maxpools on resident int8, route 28's
     two sources (the reorg of conv 26's fp32 output and conv 24) in one
     K6, conv 29 on split groups 256 + 1024; (d) at 256, the second half
     from seed 26), plus the int8 stem alone on its real inputs: the
     packed route and the ``mma.sync`` core (the byte path it replaced),
     each equal to the plain version, their device times in turns from
     CUDA graphs, beside its bound, its plain version, K5 and cuDNN bf16
     on the same conv;
 27. yolov2-tiny@416, batch 128: as 26 (9 K5; int8sb 8 K4, the stem on
     the packed route, the 2x2 stride-1 pool at 13² on int8; no concat
     route; (d) at 256 from seed 27).
     Phases 18 and 20-27 time every maxpool alone on the grid at its stride
     (SPP's: 32 up to yolov4x-mish, 64 on p6, 128 on p7), in bf16 and, where
     int8sb keeps it on resident int8, in int8.

Each phase's wall seconds are printed on one line before the report.
The line before the second-to-last is the kernels' JSON report (``ms``
eager time, as every kernel's figure since the port began; ``device_ms``
the CUDA-graph device time of the same calls); the
second-to-last is the card as nvidia-smi names it; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or run outside the
repository, the script exits non-zero and prints no result.
Synthetic He-init weights (seed 0) in phases 3-9, live (equalized) ones
in 10-27; frames from numpy seed 0 (phase 16: seed 16; phase 17b: seed 17;
26d and 27d: their second halves from seeds 26 and 27).
"""

from __future__ import annotations

import collections
import hashlib
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
K2_LARGE = (1025, 2048, 10647)  # phase 14: K past the shared-memory 1024; 10,647 = D at 416
# phase 15: each rate is timed over WINDOWS windows of several seconds, in turns
WINDOWS, MANY_WINDOW, STREAM_WINDOW, SERVE_WINDOW, SERVE_CLIENTS = 3, 384, 480, 384, 16
# phase 16: evaluate's batch candidates, timed over EVAL_WINDOW frames a window
EVAL_BATCHES, EVAL_WINDOW = (8, 16, 32, 64), 192
EVAL_RESO = (384, 512)  # phase 16's self-set: the 480x640 frames' aspect, no letterbox padding
# the 80 COCO category ids, in the dense order of coco.names
COCO_IDS = (tuple(range(1, 12)) + tuple(range(13, 26)) + (27, 28) + tuple(range(31, 45))
            + tuple(range(46, 66)) + (67, 70) + tuple(range(72, 83)) + tuple(range(84, 91)))
TOL = 1e-5  # K1: expf and summation order; box columns relative to the row's corners
# H100 SXM published dense peaks (NVIDIA data sheet, 700 W): the bounds' rates.
PEAK_INT8_OPS = 1.979e15
PEAK_BF16_OPS = 989e12
PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# phases 18-19: yolov4 at the published cfg's 608 (batch 64: 23.7 M pixels a
# step, about yolov3@416's batch 128), yolov4-tiny at 416 and batch 128
V4, V4_SIZE, V4_BATCH, V4_TINY = "yolov4", 608, 64, "yolov4-tiny"
# phases 20-21: the Scaled-YOLOv4 CSP family at the published sizes, (name,
# size, batch): yolov4-csp@512 at batch 128 (33.6 M pixels a step),
# yolov4x-mish@640 at batch 64 (26.2 M)
CSP = (("yolov4-csp", 512, 128), ("yolov4x-mish", 640, 64))
# phases 22-24: the Scaled-YOLOv4 large family at the published sizes, each
# batch near yolov3@416's 22 M pixels a step (p7: 18.9 M): yolov4-p5@896 at
# batch 32 (25.7 M), yolov4-p6@1280 at 16 (26.2 M), yolov4-p7@1536 at 8
LARGE = (("yolov4-p5", 896, 32), ("yolov4-p6", 1280, 16), ("yolov4-p7", 1536, 8))
# phases 25-27: the zoo's last three families, (name, size, batch):
# yolov3-spp at its published cfg's 608 and batch 64 (23.7 M pixels a step,
# as yolov4@608), yolov2 and yolov2-tiny at 416 (their cfgs' size, the
# YOLO9000 paper's 13x13 grid) and batch 128 (22.2 M, as yolov3)
ZOO_LAST = (("yolov3-spp", 608, 64), ("yolov2", 416, 128), ("yolov2-tiny", 416, 128))
# phase 13: yolov3's C = 32 pair on the "im2col32" route at batch 128 (name
# -> (H = W, C, O, stride)), on inputs seeded as tools/profile_torch_step.py
# --k5 seeds them, and the sha1 digests (first 16 hex digits) of the
# outputs of the parent tree 4c693ce, which ran the pair on the same route
# (that tool, on an NVIDIA H100 80GB HBM3 with torch C32_TORCH): this tree
# must give the same bits where the torch version is that one.
YOLOV3_C32 = {"3x3 s2 416²->208² 32->64": (416, 32, 64, 2), "3x3 s1 208² 32->64": (208, 32, 64, 1)}
C32_DIGESTS = {"3x3 s2 416²->208² 32->64": "462f67e68e4fd1f3",
               "3x3 s1 208² 32->64": "db4192978a3f69a7"}
C32_TORCH = "2.11.0+cu128"
LAPS: list = []  # (phase, perf_counter at its start)


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
    from pytorch_yolo_tpu_torch.ops.kernels import quantize_i8
    from pytorch_yolo_tpu_torch.ops.quant import dynamic_scale

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
            parts.append(quantize_i8(xf[..., off:off + cg], sxg[g]))
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
        xq = quantize_i8(xf, sx)
        sx_val = 1.0 if sx.dim() == 1 else float(sx)
        kw["sx"] = sx
    acc_std = np.sqrt(k * k * c) * 35.0 * 73.0
    kw["ws"] = t(rng.uniform(0.5, 1.5, o) * 1.5 / acc_std / sx_val)
    if "out" in mode:
        kw["out_scale"] = t(0.012) if mode["out"] == "scalar" else t(rng.uniform(0.008, 0.016, o))
    return xq, wq, stride, k // 2, kw


# K6 cases of phase 7: name -> (NHWC shape, dtype, scale, view); as
# tests/test_torch_cuda.py: QUANT_CASES
K6_CASES = {
    "fp32 scalar": ((8, 52, 52, 256), torch.float32, "scalar", None),
    "bf16 scalar": ((8, 52, 52, 256), torch.bfloat16, "scalar", None),
    "fp32 per channel": ((8, 26, 26, 512), torch.float32, "vector", None),
    "bf16 per channel": ((8, 26, 26, 512), torch.bfloat16, "vector", None),
    "fp32 split (128, 256)": ((8, 52, 52, 384), torch.float32, (128, 256), None),
    "bf16 split (256, 512)": ((8, 26, 26, 768), torch.bfloat16, (256, 512), None),
    "fp32 C=3 ragged tail": ((1, 5, 7, 3), torch.float32, "scalar", None),
    "bf16 C=24 ragged tail": ((3, 5, 5, 24), torch.bfloat16, "vector", None),
    "fp32 offset view": ((2, 9, 9, 40), torch.float32, "scalar", "offset"),
    "bf16 channel slice": ((2, 13, 13, 32), torch.bfloat16, "vector", "slice"),
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


def k6_case(name, device):
    """(x, sx) of a K6_CASES entry: 20 % exact ties at (k + 0.5) * s, 5 %
    past +-127.5 * s, and in fp32 :func:`division_traps` in the last rows
    of every channel whose scale is not a power of two; scales powers of
    two and others (a split case: one 0-d scale a branch); ``view``
    "offset" (4 bytes off the 16-byte grid) or "slice" (the upper half of
    the channels, as a group route gives)."""
    shape, dtype, scale, view = K6_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    c = shape[-1]
    if scale == "scalar":
        per_ch = np.full(c, 2.0 ** -5, np.float32)
    elif scale == "vector":
        per_ch = (2.0 ** rng.integers(-7, -3, c)).astype(np.float32)
        per_ch[::3] = rng.uniform(0.01, 0.05, per_ch[::3].shape)
    else:
        sxg = np.array([2.0 ** -6, 0.0371][:len(scale)], np.float32)
        per_ch = np.repeat(sxg, scale)
    x = (rng.normal(0.0, 1.5, shape).astype(np.float32) * 64 * per_ch).reshape(-1, c)
    tie = rng.uniform(size=x.shape) < 0.2
    x[tie] = ((rng.integers(-130, 130, x.shape) + 0.5) * per_ch)[tie]
    sat = rng.uniform(size=x.shape) < 0.05
    x[sat] = (rng.choice([-1.0, 1.0], x.shape) * rng.uniform(127.5, 400.0, x.shape) * per_ch)[sat]
    if dtype == torch.float32:
        for ch, sc in enumerate(per_ch):
            if np.log2(sc) % 1:
                t = division_traps(sc)
                x[x.shape[0] - len(t):, ch] = t
    x = torch.from_numpy(x.reshape(shape)).to(device=device, dtype=dtype)
    if view == "offset":
        buf = torch.zeros(x.numel() + 1, dtype=dtype, device=device)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(shape)
    elif view == "slice":
        x = torch.cat([torch.zeros_like(x), x], -1)[..., c:]
    if scale == "scalar":
        return x, torch.tensor(per_ch[0], device=device)
    if scale == "vector":
        return x, torch.from_numpy(per_ch).to(device)
    return x, [torch.tensor(v, device=device) for v in sxg]


def k6_inputs(name, x, sx):
    """A K6_CASES input as K6 takes it (a split case's channel slices of the
    concat, each read in place), and one scale a channel for comparisons."""
    widths = K6_CASES[name][2]
    if not isinstance(widths, tuple):
        return x, sx
    offs = np.cumsum((0,) + widths)
    return ([x[..., o:o + c] for o, c in zip(offs, widths)],
            torch.cat([s.reshape(1).expand(c) for s, c in zip(sx, widths)]))


# phase 7: a route's sources handed to K6 (its read-through), each its own
# tensor: name -> (leading shape, (width, dtype) a branch, scale: "split" one
# a branch, "shared" one for all, "dynamic" from absmax over the branches)
K6_BRANCH_CASES = {
    "24 fp32 + 40 bf16, split": ((2, 13, 13), ((24, torch.float32), (40, torch.bfloat16)),
                                 "split"),
    "24 bf16 + 40 fp32, dynamic": ((2, 13, 13), ((24, torch.bfloat16), (40, torch.float32)),
                                   "dynamic"),
    "128 bf16 + 256 fp32, split": ((8, 52, 52), ((128, torch.bfloat16), (256, torch.float32)),
                                   "split"),
    "128 fp32 + 256 fp32, shared": ((8, 52, 52), ((128, torch.float32), (256, torch.float32)),
                                    "shared"),
    "256 fp32 + 512 bf16, dynamic": ((8, 26, 26), ((256, torch.float32), (512, torch.bfloat16)),
                                     "dynamic"),
    "256 fp32 + 512 fp32, split": ((8, 26, 26), ((256, torch.float32), (512, torch.float32)),
                                   "split"),
    "3 fp32 + 5 bf16 + 8 fp32, split": ((1, 7, 9), ((3, torch.float32), (5, torch.bfloat16),
                                                    (8, torch.float32)), "split"),
    # yolov4's SPP route 113: four 512-channel sources at 19² (608)
    "4 x 512 fp32 (SPP), shared": ((8, 19, 19), ((512, torch.float32),) * 4, "shared"),
    "512 bf16 + 3 x 512 fp32 (SPP), split": ((8, 19, 19), ((512, torch.bfloat16),)
                                             + ((512, torch.float32),) * 3, "split"),
}


def k6_branch_case(name, device):
    """(sources, scale) of a K6_BRANCH_CASES entry: ties, saturated values
    and, in fp32, :func:`division_traps` at each branch's scale; ``scale``
    None for a dynamic case."""
    lead, branches, mode = K6_BRANCH_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    sxg = np.array([0.0371, 2.0 ** -6, 0.0219, 0.0293][:len(branches)], np.float32)
    if mode != "split":
        sxg[:] = sxg[0]
    xs = []
    for (c, dtype), s in zip(branches, sxg):
        x = (rng.normal(0.0, 1.5, (*lead, c)).astype(np.float32) * 64 * s).reshape(-1, c)
        tie = rng.uniform(size=x.shape) < 0.2
        x[tie] = ((rng.integers(-130, 130, x.shape) + 0.5) * s)[tie]
        if dtype == torch.float32:
            t = division_traps(s)
            x[x.shape[0] - len(t):, :] = t[:, None]
        xs.append(torch.from_numpy(x.reshape(*lead, c)).to(device=device, dtype=dtype))
    if mode == "split":
        return xs, [torch.tensor(v, device=device) for v in sxg]
    return xs, torch.tensor(sxg[0], device=device) if mode == "shared" else None


# phase 7's sweeps of K6's quotient over bit patterns: scales that are
# powers of two, 1/127-style (a dynamic scale) and neither
SWEEP_SCALES = (2.0 ** -7, 1.0 / 127.0, float(np.float32(5.3) / np.float32(127) + 1e-12),
                0.0371, 3.75)
SWEEP_CHUNK = 1 << 28  # fp32 patterns a launch


def sweep_k6(kernels, dev) -> dict:
    """K6 against its plain version over every bf16 bit pattern at each of
    SWEEP_SCALES, and over every fp32 bit pattern (in chunks of
    SWEEP_CHUNK) at each scale (NaN, inf, subnormals and all); also counts the patterns where a multiply by the
    reciprocal (what a quantizer that does not divide computes) would give
    another int8.  Fails on any difference."""
    out = {"bf16_patterns": 1 << 16, "fp32_patterns": 1 << 32, "scales": list(SWEEP_SCALES),
           "naive_differs": {}}
    bf16 = torch.arange(-32768, 32768, dtype=torch.int32, device=dev).to(torch.int16)
    bf16 = bf16.view(torch.bfloat16).reshape(256, 256)
    t0 = time.perf_counter()
    for s in SWEEP_SCALES:
        sx = torch.tensor(s, dtype=torch.float32, device=dev)
        ref = kernels.quantize_i8_ref(bf16, sx)
        if not torch.equal(kernels.quantize_i8(bf16, sx), ref):
            fail(f"K6 bf16 sweep at s = {s!r}: differs from the plain version")
        naive = 0
        for c0 in range(-(1 << 31), 1 << 31, SWEEP_CHUNK):
            x = torch.arange(c0, c0 + SWEEP_CHUNK, dtype=torch.int64, device=dev).to(
                torch.int32).view(torch.float32)
            ref = kernels.quantize_i8_ref(x, sx)
            ours = kernels.quantize_i8(x, sx)
            if not torch.equal(ours, ref):
                bad = (ours != ref).nonzero()[:4, 0]
                fail(f"K6 fp32 sweep at s = {s!r}: {int((ours != ref).sum())} patterns differ, "
                     f"e.g. {x[bad].tolist()} -> {ours[bad].tolist()} vs {ref[bad].tolist()}")
            naive += int((kernels.quantize_i8_ref(x * (1.0 / sx), torch.ones_like(sx)) != ref)
                         .sum())
            del x, ref, ours
        out["naive_differs"][repr(s)] = naive
    torch.cuda.synchronize()
    out["seconds"] = time.perf_counter() - t0
    return out


# phase 7: values of m for the scale that absmax writes: 0, every power of
# two (subnormal ones too), random subnormals and values over the range
def scale_sweep_values() -> np.ndarray:
    rng = np.random.default_rng(3)
    return np.concatenate([[0.0], 2.0 ** np.arange(-149, 128),
                           rng.integers(1, 1 << 23, 100).astype(np.uint32).view(np.float32),
                           np.exp(rng.uniform(-80, 80, 822))]).astype(np.float32)


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


def check_shortcut(kernels, errs, where, name, xq, wq, stride, pad, kw, sdt) -> None:
    """K3/K4 with a [shortcut] operand of dtype ``sdt`` (N(0, 1), the
    output's shape) on the core ``igemm_plan`` picks and on the ``mma.sync``
    core, against the plain version: within 1e-6 of the larger of |out| and
    |operand|, one launch each; the error is folded into ``errs``."""
    n, h, w, _ = xq.shape
    o, k = wq.shape[0], wq.shape[1]
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    sc = torch.randn((n, ho, wo, o), device=xq.device,
                     generator=torch.Generator(xq.device).manual_seed(3)).to(sdt)
    kw = {**kw, "shortcut": sc.reshape(n * ho * wo, o) if k == 1 and stride == 1 else sc}
    ref = run_int8(kernels, xq, wq, stride, pad, kw, plain=True)
    if torch.equal(ref, run_int8(kernels, xq, wq, stride, pad, {**kw, "shortcut": None},
                                 plain=True)):
        fail(f"K3/K4 shortcut {name}: the operand changed nothing in the plain version")
    lim = 1e-6 * torch.maximum(ref.abs(), sc.float().reshape(ref.shape).abs())
    for mma in (False, True):
        key = int8_key(kernels, wq, stride, kw, mma)
        before = kernels.LAUNCHES[key]
        ours = run_int8(kernels, xq, wq, stride, pad, kw, mma=mma)
        torch.cuda.synchronize()
        if kernels.LAUNCHES[key] != before + 1:
            fail(f"{name}: expected one launch of {key}, counts {kernels.LAUNCHES}")
        gap = abs_diff(ours, ref)
        if ours.shape != ref.shape or not bool((gap <= lim).all()):
            fail(f"{key} shortcut {name}: kernel disagrees with its plain version "
                 f"(max abs err {float(gap.max()):.3g})")
        base = key.removesuffix("_mma")
        errs[base] = max(errs[base], float(gap.max()))
        say(f"{where} {key} shortcut {name} {tuple(xq.shape)}->{o}: ok, max abs err "
            f"{float(gap.max()):.3g} (tol 1e-6 of max(|out|, |operand|))")


def int8_key(kernels, wq, stride, kw, mma: bool = False) -> str:
    """The LAUNCHES key of the core ``igemm_plan`` picks for a K3/K4 call
    (``mma``: of the ``mma.sync`` core, which ``_mma=True`` forces)."""
    name = "int8_gemm" if wq.shape[1] == 1 and stride == 1 else "int8_conv"
    if mma:
        return name + "_mma"
    c, k = wq.shape[-1], wq.shape[1]
    goff = [0, c]
    if "splits" in kw:
        goff = [0]
        for g in kw["splits"]:
            goff.append(goff[-1] + g)
    core, _ = kernels.igemm_plan(c, goff, wq.shape[0], "splits" in kw, True, k, wq.shape[2],
                                 stride, k // 2, kw.get("shortcut") is not None)
    return {"wgmma": name, "packed": name + "_packed", "mma": name + "_mma"}[core]


# The first K6's device ms (the simple kernel before its Hopper redesign;
# PERF.md §6, an H100 80GB HBM3 at 700 W), printed beside this run's
K6_BEFORE = {"fp32": 0.1788, "bf16": 0.1050, "fp32 per channel": 0.2064, "absmax": 0.1179}


def device_ops(step) -> int:
    """Device operations (kernels, memsets, copies) one call of ``step``
    enqueues, as torch.profiler lists them."""
    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def wide_ops(fn) -> dict:
    """The aten ops ``fn`` runs that touch a float64 tensor or fill one
    with ``full_like``, by name (a TorchDispatchMode sees every op)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    seen: dict = {}

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            leaves = tree_leaves((args, kwargs, out))
            if "full_like" in str(func) or any(isinstance(t, torch.Tensor)
                                               and t.dtype == torch.float64 for t in leaves):
                seen[str(func)] = seen.get(str(func), 0) + 1
            return out

    with Watch():
        fn()
    return seen


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


def check_result(res, what: str, batch: int = BATCH) -> None:
    if tuple(res.boxes.shape) != (batch, MAX_DET, 4) or not bool(res.valid.any()):
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


def k1_one_launch(kernels, name, size, spec, heads) -> float:
    """K1 on a model's bf16 ``heads`` in one launch: rows close to its plain
    version's and equal to K1's on their fp32 widening.  Returns the
    largest error against the plain version."""
    before = dict(kernels.LAUNCHES)
    ours = kernels.decode_score_all(heads, spec)
    torch.cuda.synchronize()
    if kernels.LAUNCHES != {**before, "decode_score": before["decode_score"] + 1}:
        fail(f"K1 on {name}'s {len(heads)} bf16 heads: expected one launch, counts "
             f"{kernels.LAUNCHES}")
    ref = plain_rows(kernels, heads, spec)
    err = max_err(ours, ref)
    if not rows_close(ours, ref):
        fail(f"K1 bf16 {name} heads at {size}: kernel disagrees with its plain version ({err})")
    if not torch.equal(ours, kernels.decode_score_all(tuple(h.float() for h in heads), spec)):
        fail(f"K1 bf16 {name} heads: rows differ from K1's on their fp32 widening")
    kinds = sorted({(p.cls_act, p.scale_xy, p.new_coords)
                    for p in kernels.decode_plan(heads, spec)})
    say(f"phase 3 K1 {name}@{size} bf16 heads ({len(heads)} heads of "
        f"{[h.shape[-1] for h in heads]} channels, grids {[h.shape[1] for h in heads]}, "
        f"{ours.shape[1]:,} rows a frame; classes, scale_x_y, new_coords {kinds}), batch "
        f"{ours.shape[0]}, one launch: ok, max abs err {err:.3g}, equal to K1 on the fp32 "
        f"widening")
    return err


def chain_boxes(n: int, k: int, device):
    """K boxes in a row, box i = [i, 0, i+3, 10]: IoU 0.5 with its successor,
    0.2 with the one after, so greedy NMS keeps every other box and the
    parallel fixpoint needs K rounds.  All valid, one class."""
    x = torch.arange(k, dtype=torch.float32, device=device)
    row = torch.stack([x, torch.zeros_like(x), x + 3, torch.full_like(x, 10.0)], -1)
    return (row.expand(n, k, 4).contiguous(), torch.ones((n, k), dtype=torch.bool, device=device),
            torch.zeros((n, k), device=device))


def nms_bound(valid_mask, cls=None) -> tuple[float, str]:
    """K2 reads boxes, valid (and class ids) and writes the mask once.  The
    relation needs ~15 fp32 ops for each pair j < i of valid candidates that
    can suppress one another: every pair without class ids, else only the
    same-class pairs, and one compare for each other pair (the kernel skips
    their IoU).  The pairs are counted on this call's data."""
    n, k = valid_mask.shape
    v = valid_mask.sum(1).double()
    pairs = v * (v - 1) / 2
    if cls is None:
        ops = 15 * float(pairs.sum())
    else:
        ids = cls.round().long().clamp_min(0)
        counts = torch.zeros((n, int(ids.max()) + 1), dtype=torch.float64, device=ids.device)
        counts.scatter_add_(1, ids, valid_mask.double())
        same = (counts * (counts - 1) / 2).sum(1)
        ops = float((15 * same + (pairs - same)).sum())
    return bound(ops, n * k * (16 + 1 + 1 + (4 if cls is not None else 0)), PEAK_FP32_OPS)


def spread(runs: list) -> dict:
    """The median of repeated readings and their spread, (max - min) / median."""
    med = statistics.median(runs)
    return dict(median=med, spread=(max(runs) - min(runs)) / med,
                runs=[round(r, 3) for r in runs])


def bf16_steps(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as integers in the order of the reals: neighbouring bf16
    values differ by one."""
    v = t.to(torch.bfloat16).view(torch.int16).to(torch.int32)
    return torch.where(v < 0, -(v & 0x7FFF), v)


def k5_agreement(ours, ref, x, w, b, stride, pad, shortcut=None) -> tuple[float, int, float]:
    """(share of bit-equal outputs, largest distance in bf16 steps outside
    the order error of an fp32 sum, largest absolute error) of K5 against
    its plain version.  The order error: 2^-20 of sum |x w| + |b| (16 fp32
    ulps of the terms' scale; where the bias cancels the sum the output is
    far below that scale), plus one bf16 step of the conv output where a
    shortcut is added after it."""
    F = torch.nn.functional
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        terms = F.conv2d(x.float().abs().permute(0, 3, 1, 2), w.float().abs().permute(0, 3, 1, 2),
                         stride=stride, padding=pad).permute(0, 2, 3, 1) + b.abs()
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    floor = terms * 2.0 ** -20 + (terms * 2.0 ** -7 if shortcut is not None else 0.0)
    gap = (ours.float() - ref.float()).abs()
    d = (bf16_steps(ours) - bf16_steps(ref)).abs()
    equal = float((d == 0).double().mean())
    steps = int(torch.where(gap <= floor, torch.zeros_like(d), d).max())
    return equal, steps, float(gap.max())


def was_gather(c: int, o: int, k: int, stride: int, pad: int) -> bool:
    """True for a conv that K5's 16-byte gather route ran before the packed
    route took the RGB stem up to 64 outputs and the "im2col16" route took C
    % 32 != 0: C % 32 != 0, not a 1x1 stride-1 conv, not a 3x3 stem of at
    most 32 outputs."""
    return (c % 32 != 0 and not (k == 1 and stride == 1 and pad == 0)
            and not (k == 3 and c == 3 and o <= 32))


def k5_scaled(kernels, frames, dev, card, scaled_live) -> dict:
    """K5 against its plain version on every distinct conv of the
    Scaled-YOLOv4 models of :data:`CSP` and :data:`LARGE` and of the
    models of :data:`ZOO_LAST` at batch 4 (their bf16 live forwards' conv
    inputs: mish and leaky, the logistic, linear and [region] heads, the
    former gather convs, a fused shortcut where the model has one); then
    each distinct former gather conv (:func:`was_gather`: yolov4x-mish's,
    yolov4-p7's and yolov2-tiny's) and each distinct "im2col_pad" conv
    (C % 64 == 32, C > 32: yolov4x-mish's and yolov4-p7's) at its path's
    batch, on those inputs repeated: K5's eager and device time beside its
    bound, its plain version and cuDNN's bf16 ``F.conv2d`` + bf16 bias +
    the conv's activation, in turns; a former gather conv also beside the
    16-byte gather route it ran on before (``conv_bf16(...,
    _route="gather")``, device time in turns), an "im2col_pad" conv beside
    the "im2col32" route it ran on before (``_route="im2col32"``, the same),
    and yolov4x-mish's 80² 160->160 conv also with leaky against its mish,
    in turns."""
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch

    F = torch.nn.functional
    worst = {"equal": 1.0, "steps": 0, "abs": 0.0}
    cases, gather, padded = 0, {}, {}
    for name, size, batch in CSP + LARGE + ZOO_LAST:
        spec, live = scaled_live[name]
        det = Detector(spec, live, device=dev, dtype=torch.bfloat16, precision="default")
        per_step: dict = {}
        w, n, keys, inputs = k5_cases(kernels, det, letterbox_batch(frames[:4], size),
                                      f"{name}@{size}", per_step=per_step)
        worst = {k: (min if k == "equal" else max)(worst[k], w[k]) for k in worst}
        cases += n
        plans = {i: kernels.conv_bf16_plan(k[0][3], k[1][0], k[1][1], k[1][2], k[2], k[3])
                 for k, i in keys.items()}
        say(f"phase 13 K5: {n} cases (every distinct conv of {name}@{size} batch 4: routes "
            f"{sorted(collections.Counter(p[0] for p in plans.values()).items())}), worst "
            f"{w['equal']:.4%} bit-equal, {w['steps']} step")
        for key, i in keys.items():
            c = det.model.convs[str(i)]
            (n4, h, wd, ch), ws = key[0], key[1]
            old = was_gather(ch, ws[0], ws[1], c.stride, c.padding)
            if not (old or plans[i][0] == "im2col_pad"):
                continue
            ho = (h + 2 * c.padding - ws[1]) // c.stride + 1
            label = (f"{name} conv {i} {ws[1]}x{ws[2]} s{c.stride} {h}²"
                     + (f"->{ho}²" if c.stride > 1 else "") + f" {ch}->{ws[0]}")
            x = inputs[i].repeat(-(-batch // n4), 1, 1, 1)[:batch]
            k5 = lambda: kernels.conv_bf16(x, c.weight, c.bias, c.stride, c.padding, c.activation)  # noqa: E731
            ours = k5()
            ref = kernels.conv_bf16_ref(x, c.weight, c.bias, c.stride, c.padding, c.activation)
            equal, steps, err = k5_agreement(ours, ref, x, c.weight, c.bias, c.stride, c.padding)
            if equal < 0.999 or steps > 1:
                fail(f"K5 {label} batch {batch}: {equal:.5%} bit-equal, {steps} steps")
            del ours, ref
            xc = x.permute(0, 3, 1, 2)
            wc = c.weight.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
            bc = c.bias.to(torch.bfloat16)
            act = {"mish": lambda y: F.mish(y, inplace=True),
                   "leaky": lambda y: F.leaky_relu(y, 0.1, inplace=True)}[c.activation]
            lib = lambda: act(F.conv2d(xc, wc, bc, stride=c.stride,  # noqa: E731
                                       padding=c.padding))
            ms, lib_ms = in_turns(lib, k5)
            dev_ms, lib_dev_ms = in_turns(lib, k5, timer=graph_ms)
            plain_ms = time_ms(lambda: kernels.conv_bf16_ref(x, c.weight, c.bias, c.stride,
                                                             c.padding, c.activation), 3, 1)
            ops, nbytes = kernels.conv_bf16_work(tuple(x.shape), tuple(c.weight.shape), c.stride,
                                                 c.padding)
            bms, by = bound(ops, nbytes, PEAK_BF16_OPS)
            per = per_step[(key[0][1:], ws, c.stride)]
            row = dict(launches_per_step=per, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                       library_ms=lib_ms, library_device_ms=lib_dev_ms, bound_ms=bms,
                       bound_by=by, equal=equal, max_abs_err=err, plan=list(plans[i]),
                       bytes=nbytes, flops=ops)
            was = ""
            if old:  # the 16-byte gather route it ran on before, device time in turns
                gather_k5 = lambda: kernels.conv_bf16(  # noqa: E731
                    x, c.weight, c.bias, c.stride, c.padding, c.activation, _route="gather")
                new_ms, gather_ms = in_turns(gather_k5, k5, timer=graph_ms)
                row.update(device_ms_vs_gather=new_ms, gather_device_ms=gather_ms)
                was = (f"; the gather route it replaced {gather_ms:.4f} ms device in turns "
                       f"({gather_ms / new_ms:.2f}x this route's {new_ms:.4f})")
                other = "im2col16" if plans[i][0] == "halo" else None
                if other:
                    # the design the plan did not pick for this conv, in turns
                    other_k5 = lambda: kernels.conv_bf16(  # noqa: E731
                        x, c.weight, c.bias, c.stride, c.padding, c.activation, _route=other)
                    o_out = other_k5()
                    if not torch.equal(o_out, k5()):
                        fail(f"K5 {label}: the {other} route's output differs from the "
                             f"{plans[i][0]} route's (both sum in one order)")
                    del o_out
                    new2_ms, other_ms = in_turns(other_k5, k5, timer=graph_ms)
                    row.update(other_route=other, other_route_device_ms=other_ms,
                               device_ms_vs_other=new2_ms)
                    was += (f"; the {other} route {other_ms:.4f} ms device in turns "
                            f"({other_ms / new2_ms:.2f}x)")
            else:  # the "im2col32" route it ran on before, device time in turns
                old_k5 = lambda: kernels.conv_bf16(  # noqa: E731
                    x, c.weight, c.bias, c.stride, c.padding, c.activation, _route="im2col32")
                new_ms, old_ms = in_turns(old_k5, k5, timer=graph_ms)
                row.update(device_ms_vs_im2col32=new_ms, im2col32_device_ms=old_ms)
                was = (f"; the im2col32 route it replaced {old_ms:.4f} ms device in turns "
                       f"({old_ms / new_ms:.2f}x this route's {new_ms:.4f})")
                if name == "yolov4x-mish" and (h, ch, ws[0], c.stride) == (80, 160, 160, 1):
                    # mish's epilogue against leaky's on this route, in turns
                    leaky = lambda: kernels.conv_bf16(  # noqa: E731
                        x, c.weight, c.bias, c.stride, c.padding, "leaky")
                    mish_ms, leaky_ms = in_turns(leaky, k5, timer=graph_ms)
                    row.update(mish_device_ms=mish_ms, leaky_device_ms=leaky_ms)
                    was += (f"; with leaky {leaky_ms:.4f} ms device against mish "
                            f"{mish_ms:.4f} in turns ({mish_ms / leaky_ms - 1:+.1%})")
            (gather if old else padded)[label] = row
            say(f"phase 13 K5 {'former gather' if old else 'im2col_pad'} {label} batch {batch} "
                f"({per} a step, plan {plans[i]}): {ms:.4f} ms eager, {dev_ms:.4f} ms device "
                f"({bms / dev_ms:.1%} of its {bms:.4f} ms bound, {by}: {ops / 1e9:.1f} GFLOP, "
                f"{nbytes / 1e9:.3f} GB); cuDNN bf16 conv + bf16 bias + {c.activation} "
                f"{lib_ms:.4f} ms eager, {lib_dev_ms:.4f} ms device, in turns "
                f"({lib_dev_ms / dev_ms:.2f}x K5's){was}; plain {plain_ms:.4f} ms; "
                f"{equal:.4%} bit-equal to the plain version; on {card}")
            del x, xc
        del det, inputs
        torch.cuda.empty_cache()
    return dict(worst=worst, cases=cases, gather=gather, im2col_pad=padded)


def phase13_k5(kernels, v3, live, frames, dev, card, v4, v4_live) -> dict:
    """K5 against its plain version on every distinct conv of yolov3@416 at
    batch 8 and of yolov4@608 at batch 4 (real activations), each
    activation and a fused shortcut; K5 with mish against leaky at
    yolov4's 608² stride-2 conv; then its times at batch 128 at every
    distinct yolov3 shape off the 2-D TMA route and at the largest 1x1."""
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch

    det = Detector(v3, live, device=dev, dtype=torch.bfloat16, precision="default")
    g = SIZE // 8  # 52 at 416
    per_step: dict = {}  # (input HWC, weight shape, stride) -> convs of that shape in a step
    worst, n3, keys, inputs = k5_cases(kernels, det, letterbox_batch(frames[:8], SIZE),
                                       f"yolov3@{SIZE}", ((8, g, g, 128), (256, 3, 3, 128)),
                                       per_step)
    say(f"phase 13 K5: {n3} cases (every distinct conv of yolov3@{SIZE} batch 8), worst "
        f"{worst['equal']:.4%} bit-equal, {worst['steps']} step")
    det4 = Detector(v4, v4_live, device=dev, dtype=torch.bfloat16, precision="default")
    worst4, n4, _, _ = k5_cases(kernels, det4, letterbox_batch(frames[:4], V4_SIZE),
                                f"yolov4@{V4_SIZE}")
    say(f"phase 13 K5: {n4} cases (every distinct conv of yolov4@{V4_SIZE} batch 4), worst "
        f"{worst4['equal']:.4%} bit-equal, {worst4['steps']} step")
    worst = {k: (min if k == "equal" else max)(worst[k], worst4[k]) for k in worst}
    del det4
    # mish's epilogue (expf, log1pf, tanhf an output) against leaky's at
    # yolov4's 608² stride-2 conv (small K), batch 64, in turns
    c1 = next(l for l in v4.layers if type(l).__name__ == "ConvSpec" and l.stride == 2)
    gen = torch.Generator(dev).manual_seed(13)
    x1 = torch.randn((V4_BATCH, V4_SIZE, V4_SIZE, c1.in_channels), device=dev,
                     generator=gen).to(torch.bfloat16)
    w1 = (torch.randn((c1.filters, 3, 3, c1.in_channels), device=dev, generator=gen)
          * (2.0 / (9 * c1.in_channels)) ** 0.5).to(torch.bfloat16)
    b1 = torch.randn(c1.filters, device=dev, generator=gen) * 0.5
    mish_ms, leaky_ms = in_turns(lambda: kernels.conv_bf16(x1, w1, b1, 2, 1, "leaky"),
                                 lambda: kernels.conv_bf16(x1, w1, b1, 2, 1, "mish"),
                                 timer=graph_ms)
    ops1, bytes1 = kernels.conv_bf16_work(tuple(x1.shape), tuple(w1.shape), 2, 1)
    b_ms, b_by = bound(ops1, bytes1, PEAK_BF16_OPS)
    mish_leaky = dict(layer=c1.index, mish_ms=mish_ms, leaky_ms=leaky_ms, bound_ms=b_ms,
                      bound_by=b_by)
    say(f"phase 13 K5 yolov4 conv {c1.index} 3x3 s2 {V4_SIZE}²->{V4_SIZE // 2}² "
        f"{c1.in_channels}->{c1.filters} batch {V4_BATCH}: mish {mish_ms:.4f} ms device, leaky "
        f"{leaky_ms:.4f} ms device, in turns ({mish_ms / leaky_ms - 1:+.1%}); bound "
        f"{b_ms:.4f} ms ({b_by}); on {card}")
    del x1, w1

    # K5 at batch 128 at every distinct conv shape of yolov3@416 whose A does
    # not come by a 2-D TMA box (im2col, im2col32 and packed routes), and at
    # its largest 1x1, each on that layer's real activations
    timed = {}
    F = torch.nn.functional
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    shapes = [k for k in per_step
              if kernels.conv_bf16_plan(k[0][2], k[1][0], k[1][1], k[1][2], k[2],
                                        k[1][1] // 2)[0] != "tma"]
    g = SIZE // 8  # 52 at 416
    shapes.append(((g, g, 256), (128, 1, 1, 256), 1))
    for xs, ws, stride in shapes:
        i = next(j for k, j in keys.items() if k[0][1:] == xs and k[1] == ws and k[2] == stride)
        c = det.model.convs[str(i)]
        name = (f"{ws[1]}x{ws[2]} s{stride} {xs[0]}²"
                + (f"->{(xs[0] + 2 * c.padding - ws[1]) // stride + 1}²" if stride > 1 else "")
                + f" {xs[2]}->{ws[0]}")
        x = inputs[i].repeat(BATCH // 8, 1, 1, 1)
        k5 = lambda: kernels.conv_bf16(x, c.weight, c.bias, c.stride, c.padding, c.activation)  # noqa: E731
        ours = k5()
        ref = kernels.conv_bf16_ref(x, c.weight, c.bias, c.stride, c.padding, c.activation)
        equal, steps, _ = k5_agreement(ours, ref, x, c.weight, c.bias, c.stride, c.padding)
        if equal < 0.999 or steps > 1:
            fail(f"K5 {name} batch {BATCH}: {equal:.5%} bit-equal, {steps} steps")
        del ours, ref
        xc = x.permute(0, 3, 1, 2)  # channels_last NCHW view, as the path before K5 ran it
        wc = c.weight.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        bc = c.bias.to(torch.bfloat16)
        lib = lambda: F.leaky_relu(F.conv2d(xc, wc, bc, stride=c.stride, padding=c.padding),  # noqa: E731
                                   0.1, inplace=True)
        ms, lib_ms = in_turns(lib, k5)
        dev_ms, lib_dev_ms = in_turns(lib, k5, timer=graph_ms)
        plain_ms = time_ms(lambda: kernels.conv_bf16_ref(x, c.weight, c.bias, c.stride,
                                                         c.padding, c.activation), 3, 1)
        ops, nbytes = kernels.conv_bf16_work(tuple(x.shape), tuple(c.weight.shape), c.stride,
                                             c.padding)
        bms, by = bound(ops, nbytes, PEAK_BF16_OPS)
        plan = kernels.conv_bf16_plan(x.shape[-1], ws[0], ws[1], ws[2], c.stride, c.padding)
        # modelled from the shapes, not read from a counter: the bytes the
        # tiles' loads bring into shared memory, and the measured time over
        # the modelled stages an SM
        tiles, ksteps, loads = kernels.conv_bf16_traffic(tuple(x.shape), ws, c.stride,
                                                         c.padding)
        us_stage = dev_ms * 1e3 / (tiles * ksteps / sms)
        timed[name] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
                           library_device_ms=lib_dev_ms,
                           bound_ms=bms, bound_by=by, equal=equal, plan=list(plan),
                           launches_per_step=per_step[(xs, ws, stride)],
                           model_tile_load_bytes=loads, model_us_per_stage_per_sm=us_stage)
        say(f"phase 13 K5 {name} batch {BATCH} (layer {i}, {plan[0]}, BN {plan[1]}, "
            f"{per_step[(xs, ws, stride)]} a step): {ms:.4f} ms eager, {dev_ms:.4f} ms device "
            f"({bms / dev_ms:.1%} of its {bms:.4f} ms bound, {by}: {ops / 1e9:.1f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB; {ops / dev_ms / 1e9:.1f} TFLOP/s); cuDNN bf16 conv + bf16 "
            f"bias + leaky {lib_ms:.4f} ms in turns ({lib_ms / ms:.2f}x), {lib_dev_ms:.4f} ms "
            f"device in turns ({lib_dev_ms / dev_ms:.2f}x); plain {plain_ms:.4f} "
            f"ms; model: {loads / 1e9:.3f} GB of tile loads ({loads / dev_ms / 1e9:.2f} TB/s "
            f"at the measured time), {us_stage:.3f} us a stage a SM ({tiles} tiles x {ksteps} "
            f"stages); "
            f"{equal:.4%} bit-equal to the plain version; on {card}")
        del x, xc
    say(f"phase 13 timings: {json.dumps(timed, ensure_ascii=False)}")
    del det, inputs
    # yolov3's C = 32 pair keeps the "im2col32" route: its outputs' bits
    # against the parent tree's
    digests = {}
    for name, (h, c, o, stride) in YOLOV3_C32.items():
        g = torch.Generator(device=dev).manual_seed(sum(map(ord, name)))
        x = torch.randn((BATCH, h, h, c), device=dev, generator=g).to(torch.bfloat16)
        w = (torch.randn((o, 3, 3, c), device=dev, generator=g) * (2.0 / (9 * c)) ** 0.5).to(
            torch.bfloat16)
        b = torch.randn(o, device=dev, generator=g) * 0.5
        if kernels.conv_bf16_plan(c, o, 3, 3, stride, 1)[0] != "im2col32":
            fail(f"K5 yolov3 {name}: planned off the \"im2col32\" route")
        y = kernels.conv_bf16(x, w, b, stride, 1, "leaky")
        digests[name] = hashlib.sha1(y.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:16]
        del x, w, b, y
    same = digests == C32_DIGESTS
    if not same and torch.__version__ == C32_TORCH:
        fail(f"K5 yolov3's C = 32 pair: output digests {digests}, the parent tree's "
             f"{C32_DIGESTS}")
    say(f"phase 13 K5 yolov3's C = 32 pair (\"im2col32\", batch {BATCH}): output digests "
        f"{digests}, {'equal to' if same else 'not compared with (torch ' + torch.__version__ + ')'}"
        f" the parent tree's")
    return dict(timed=timed, worst=worst, cases=n3 + n4, mish_leaky=mish_leaky,
                c32_digests=digests, c32_equal_to_parent=same)


def phase14_k2_large(kernels, v3, live, frames, dev, rng, card) -> dict:
    """K2's large-K mode against its plain version, the live detector at
    max_det = D, and its time."""
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.config import head_strides
    from pytorch_yolo_tpu_torch.ops.nms import fixpoint_rounds, iou_matrix
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch

    for k in K2_LARGE:
        n = 8 if k < 4096 else 2
        boxes, valid, cls = crowded_boxes(rng, n, k, dev)
        for class_wise in (True, False):
            c = cls if class_wise else None
            ours = kernels.nms_keep(boxes, valid, IOU, c)
            ref = kernels.nms_keep_ref(boxes, valid, IOU, c)
            diff = int((ours != ref).sum())
            if diff:
                fail(f"K2 crowded K={k} class_wise={class_wise}: {diff} keep entries differ")
            say(f"phase 14 K2 crowded K={k} batch {n} class_wise={class_wise}: ok, keep mask "
                f"equal to the plain version's ({int(ours.sum())} kept of {int(valid.sum())})")
        del boxes, valid, cls, ours, ref
    chain = chain_boxes(4, 1025, dev)
    if not torch.equal(kernels.nms_keep(*chain[:2], IOU),
                       (torch.arange(1025, device=dev) % 2 == 0).expand(4, 1025)):
        fail("K2 on a 1025-long chain does not keep every other box")
    say("phase 14 K2 1025-long chain batch 4: ok, every other box kept")

    d = sum(SIZE // s * (SIZE // s) * len(h.anchors) for h, s in
            zip(v3.yolo_layers, head_strides(v3)))
    det = Detector(v3, live, device=dev, dtype=torch.bfloat16, precision="default")
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    res = det.raw_result(frames[:8], size=SIZE, conf=0.3, iou=IOU, max_det=d)
    torch.cuda.synchronize()
    launched = dict(kernels.LAUNCHES)
    if tuple(res.valid.shape) != (8, d) or launched["nms_keep"] != 1 or not bool(res.valid.any()):
        fail(f"max_det={d}: result {tuple(res.valid.shape)}, {int(res.valid.sum())} kept, "
             f"launches {launched}")
    with torch.no_grad():
        heads = det.model(letterbox_batch(frames[:8], SIZE), _native_heads=True)
    rows = kernels.decode_score_all(heads, det.spec)
    masked = torch.where(rows[..., 4] > 0.3, rows[..., 7], torch.full_like(rows[..., 7], -1.0))
    top, idx = torch.sort(masked, dim=1, descending=True, stable=True)
    sel = torch.gather(rows, 1, idx[..., None].expand(8, d, 8))
    boxes, cls = sel[..., :4].contiguous(), sel[..., 6].contiguous()
    valid = (top > 0).contiguous()
    keep = kernels.nms_keep(boxes, valid, IOU, cls)
    if not torch.equal(keep, kernels.nms_keep_ref(boxes, valid, IOU, cls)):
        fail(f"K2 on the live step's {d} candidates disagrees with its plain version")
    if not torch.equal(keep, res.valid):
        fail("the max_det=D detector's keep mask differs from K2 on its candidates")
    over = iou_matrix(boxes[:2]) > IOU
    over &= (cls[:2, :, None] - cls[:2, None, :]).abs() < 0.5
    rounds = fixpoint_rounds(over, valid[:2])
    del over
    k2 = lambda: kernels.nms_keep(boxes, valid, IOU, cls)  # noqa: E731
    ms, dev_ms = time_ms(k2, 10, 2), graph_ms(k2, 5)
    plain_ms = time_ms(lambda: kernels.nms_keep_ref(boxes, valid, IOU, cls), 2, 1)
    bms, by = nms_bound(valid, cls)
    crowd = crowded_boxes(rng, BATCH, MAX_DET, dev)
    small = lambda: kernels.nms_keep(crowd[0], crowd[1], IOU, crowd[2])  # noqa: E731
    small_dev_ms = graph_ms(small)
    say(f"phase 14 yolov3@{SIZE} live bf16 max_det={d} (every candidate) batch 8: one K2 launch, "
        f"{int(valid.sum())} valid, {int(keep.sum())} kept, fixpoint rounds {rounds} (2 images), "
        f"equal to the plain version; K2 {ms:.4f} ms eager, {dev_ms:.4f} ms device "
        f"({bms / dev_ms:.2%} of its {bms:.5f} ms bound, {by}); plain {plain_ms:.4f} ms; "
        f"scratch {kernels.nms_scratch_words(8, d) * 4 / 1e6:.1f} MB; K <= 1024 re-timed: "
        f"{BATCH}x{MAX_DET} crowded {small_dev_ms:.4f} ms device; on {card}")
    del det, heads, rows, sel, boxes, cls, valid, keep, crowd
    return dict(k=d, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                rounds=rounds, crowded_300_device_ms=small_dev_ms)


def phase15_prepared(kernels, v3, live, tiny_spec, tiny_live, calib_live, dev, card) -> dict:
    """The prepared path: detect_many card vs CPU, its throughput, detect_stream
    at batch 1, and the HTTP server on the card."""
    import threading
    import urllib.request

    from pytorch_yolo_tpu_torch import Detection, Detector
    from pytorch_yolo_tpu_torch.serve import encode_png, make_server
    from pytorch_yolo_tpu_torch.utils.drift import detection_drift

    mix = np.random.default_rng(7)
    shapes = ((480, 640), (300, 500), (640, 480), (123, 777), (720, 1280))
    imgs = [mix.integers(0, 256, shapes[i % 5] + (3,), dtype=np.uint8) for i in range(32)]
    out = {}
    gpu_tiny = Detector(tiny_spec, tiny_live, device=dev)
    cpu_tiny = Detector(tiny_spec, tiny_live, device="cpu")
    for transfer in ("f32", "u8"):
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        gpu = gpu_tiny.detect_many(imgs[:5], size=SIZE, conf=0.5, batch=2, transfer=transfer)
        launched = dict(kernels.LAUNCHES)
        if not (launched["decode_score"] == 3 and launched["nms_keep"] == 3):
            fail(f"tiny detect_many ({transfer}): expected 3 K1 and 3 K2 launches: {launched}")
        st = detection_drift(cpu_tiny.detect_many(imgs[:5], size=SIZE, conf=0.5, batch=2,
                                                  transfer=transfer), gpu)
        if not (st.ref_dets > 0 and st.set_agreement == 1.0):
            fail(f"yolov3-tiny detect_many {transfer} card vs CPU: {st.row()}")
        say(f"phase 15 yolov3-tiny@{SIZE} live fp32 detect_many, 5 mixed sizes in chunks of 2, "
            f"{transfer}: card vs CPU {st.row()}; launches {launched}")
    del gpu_tiny, cpu_tiny

    det = Detector(v3, live, device=dev, dtype=torch.bfloat16, precision="default")
    for transfer in ("f32", "u8"):
        det.detect_many(imgs[:8], size=SIZE, conf=CONF, batch=8, transfer=transfer)  # warm
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        many = det.detect_many(imgs, size=SIZE, conf=CONF, batch=8, transfer=transfer)
        launched = dict(kernels.LAUNCHES)
        if not (launched["decode_score"] == 4 and launched["nms_keep"] == 4
                and launched["conv_bf16"] == 4 * len(det.model.convs)):
            fail(f"bf16 detect_many ({transfer}): expected 4 K1, 4 K2 and "
                 f"{4 * len(det.model.convs)} K5 launches: {launched}")
        if len(many) != 32 or not all(np.isfinite(d.boxes).all() for d in many):
            fail(f"bf16 detect_many ({transfer}) gave {len(many)} results or non-finite boxes")
        say(f"phase 15 yolov3@{SIZE} live bf16 detect_many, 32 mixed images in chunks of 8, "
            f"{transfer}: {sum(len(d) for d in many)} dets; launches {launched}")

    # Rates over windows of several seconds, WINDOWS times in turns: the
    # median and the spread (max - min over the median) of each.
    window = imgs * (MANY_WINDOW // len(imgs))
    rates: dict = {"detect_many_f32_img_s": [], "detect_many_u8_img_s": []}
    for _ in range(WINDOWS):
        for transfer in ("f32", "u8"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det.detect_many(window, size=SIZE, conf=CONF, batch=8, transfer=transfer)
            rates[f"detect_many_{transfer}_img_s"].append(len(window) / (time.perf_counter() - t0))

    frames1 = [mix.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(24)]
    stream = frames1 * (STREAM_WINDOW // len(frames1))
    int8sb = Detector(v3, live, device=dev, dtype=torch.bfloat16, precision="default",
                      quant="w8a8", quant_calib=calib_live, quant_calib_size=SIZE,
                      quant_recipe="none")
    modes = {"stream_bf16_ms": (det, {}),
             "stream_bf16_host_u8_ms": (det, dict(host_preproc=True, transfer="u8")),
             "stream_int8sb_ms": (int8sb, {})}
    for d, kw in modes.values():
        list(d.detect_stream(frames1[:4], size=SIZE, conf=CONF, **kw))  # warm
    for name in modes:
        rates[name] = []
    for _ in range(WINDOWS):
        for name, (d, kw) in modes.items():
            t0 = time.perf_counter()
            n = sum(1 for _ in d.detect_stream(stream, size=SIZE, conf=CONF, **kw))
            rates[name].append((time.perf_counter() - t0) / n * 1e3)
    del int8sb
    out.update({k: spread(v) for k, v in rates.items()})
    for transfer in ("f32", "u8"):
        r = out[f"detect_many_{transfer}_img_s"]
        say(f"phase 15 yolov3@{SIZE} live bf16 detect_many, {len(window)} mixed images in "
            f"chunks of 8, {transfer}, {WINDOWS} windows: median {r['median']:.1f} img/s, "
            f"spread {r['spread']:.1%} ({r['runs']}; host letterbox included); on {card}")
    bf, i8 = out["stream_bf16_ms"], out["stream_int8sb_ms"]
    say(f"phase 15 yolov3@{SIZE} live detect_stream at batch 1, depth 2, {len(stream)} 480x640 "
        f"frames, {WINDOWS} windows in turns: bf16 median {bf['median']:.3f} ms/frame, spread "
        f"{bf['spread']:.1%} ({bf['runs']}); host letterbox + u8 "
        f"{out['stream_bf16_host_u8_ms']['median']:.3f} ({out['stream_bf16_host_u8_ms']['runs']}); "
        f"int8sb {i8['median']:.3f}, spread {i8['spread']:.1%} ({i8['runs']}); int8sb is "
        f"{'slower' if min(i8['runs']) > max(bf['runs']) else 'not slower beyond the spread'} "
        f"at batch 1; on {card}")

    srv = make_server(det, host="127.0.0.1", port=0, size=SIZE, conf=CONF, batch_max=8,
                      batch_timeout_ms=20.0)
    server = threading.Thread(target=srv.serve_forever, daemon=True)
    server.start()
    try:
        host, port = srv.server_address[:2]
        posts = imgs[:8]
        answers: list = [None] * len(posts)

        def post(i):
            req = urllib.request.Request(f"http://{host}:{port}/detect", data=encode_png(posts[i]),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                answers[i] = json.loads(r.read())

        for i in range(2):  # warm the buckets
            post(i)
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        threads = [threading.Thread(target=post, args=(i,)) for i in range(len(posts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        launched = dict(kernels.LAUNCHES)
        if any(a is None for a in answers) or not (launched["decode_score"]
                                                   and launched["conv_bf16"]):
            fail(f"the server did not answer every POST through the kernels: {launched}")
        served = [Detection(boxes=np.asarray(a["boxes"], np.float32).reshape(-1, 4),
                            obj=np.asarray(a["obj"], np.float32),
                            cls_score=np.asarray(a["cls_score"], np.float32),
                            cls_id=np.asarray(a["cls_id"], np.int32)) for a in answers]
        ref = det.detect_many(posts, size=SIZE, conf=CONF, transfer="u8")
        st = detection_drift(ref, served)
        if not (st.ref_dets > 0 and st.set_agreement == 1.0):
            fail(f"the server's answers differ from detect_many on the same images: {st.row()}")
        say(f"phase 15 make_server on 127.0.0.1, yolov3@{SIZE} live bf16: {len(posts)} "
            f"concurrent PNG POSTs answered, K1 {launched['decode_score']} / K5 "
            f"{launched['conv_bf16']} launches; equal to detect_many u8: {st.row()}")
        bodies = [encode_png(im) for im in imgs]

        def serve_window() -> tuple[float, list]:
            """SERVE_CLIENTS clients POST SERVE_WINDOW PNGs between them:
            (seconds, each request's seconds)."""
            todo, took, lock = iter(range(SERVE_WINDOW)), [], threading.Lock()

            def client():
                while True:
                    with lock:
                        i = next(todo, None)
                    if i is None:
                        return
                    req = urllib.request.Request(f"http://{host}:{port}/detect",
                                                 data=bodies[i % len(bodies)], method="POST")
                    t = time.perf_counter()
                    with urllib.request.urlopen(req, timeout=120) as r:
                        r.read()
                    with lock:
                        took.append(time.perf_counter() - t)

            t0 = time.perf_counter()
            threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            return time.perf_counter() - t0, took

        req_s, lat = [], []
        for _ in range(WINDOWS):
            dt, took = serve_window()
            if len(took) != SERVE_WINDOW:
                fail(f"the server answered {len(took)} of {SERVE_WINDOW} POSTs")
            req_s.append(SERVE_WINDOW / dt)
            lat.append(float(np.median(took)) * 1e3)
        out["server_req_s"], out["server_latency_ms"] = spread(req_s), spread(lat)
        r, m = out["server_req_s"], out["server_latency_ms"]
        say(f"phase 15 make_server, {SERVE_CLIENTS} clients POSTing {SERVE_WINDOW} PNGs, "
            f"{WINDOWS} windows: median {r['median']:.1f} req/s, spread {r['spread']:.1%} "
            f"({r['runs']}); median latency {m['median']:.1f} ms ({m['runs']}); server stages "
            f"({srv.stats.report().replace(chr(10), ';')}); on {card}")
    finally:
        srv.batcher.close()
        srv.shutdown()
        srv.server_close()
    del det
    return out


def phase16_cli(kernels, v3, cfg, live_raw, dev, card, root, ms6, bf16_drift) -> dict:
    """The command line at full width: yolov3@416 from cfg/yolov3.cfg with the
    live weights written as a .weights file, 16 PNG frames of 480x640."""
    import contextlib
    import io
    import tempfile

    from pytorch_yolo_tpu_torch import Detection, Detector, cli, native
    from pytorch_yolo_tpu_torch.ops.decode import decode_all
    from pytorch_yolo_tpu_torch.ops.nms import batched_nms
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch
    from pytorch_yolo_tpu_torch.serve import decode_image, encode_png
    from pytorch_yolo_tpu_torch.utils.drift import detection_drift
    from pytorch_yolo_tpu_torch.weights import load_weights, write_weights_file

    def run_cli(argv: list) -> str:
        """cli.main in this process; its standard output."""
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        if rc != 0:
            fail(f"cli {argv[0]} exited {rc}")
        return out.getvalue()

    def jsonl_dets(path: str) -> list:
        rows = [json.loads(line) for line in open(path, encoding="utf-8")]
        return [Detection(boxes=np.asarray(r["boxes"], np.float32).reshape(-1, 4),
                          obj=np.asarray(r["obj"], np.float32),
                          cls_score=np.asarray(r["cls_score"], np.float32),
                          cls_id=np.asarray(r["cls_id"], np.int32)) for r in rows]

    out: dict = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke16_")
    d = tmp.name
    try:
        # a. the .weights writer and both loaders
        w_path = os.path.join(d, "yolov3.weights")
        write_weights_file(v3, live_raw, w_path)
        t0 = time.perf_counter()
        if native.load_library() is None:
            fail("the native weights loader did not build (g++)")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p_nat = load_weights(v3, w_path, native=True)
        nat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        p_np = load_weights(v3, w_path, native=False)
        np_s = time.perf_counter() - t0
        worst = 0.0
        for i, p in p_np.items():
            for key in ("w", "b"):
                a, b = p_nat[i][key], p[key]
                if not np.allclose(a, b, rtol=1e-6, atol=1e-7):
                    fail(f"native and numpy loads differ at conv {i} {key}: "
                         f"{float(np.abs(a - b).max())}")
                worst = max(worst, float(np.abs(a - b).max()))
        out["load_ms"] = {"native": nat_s * 1e3, "numpy": np_s * 1e3}
        say(f"phase 16a weights: wrote {os.path.getsize(w_path):,} B; native loader built in "
            f"{build_s:.2f} s; load native {nat_s * 1e3:.1f} ms, numpy {np_s * 1e3:.1f} ms; "
            f"folded params equal (max abs diff {worst:.3g}, rtol 1e-6, atol 1e-7)")

        # b. detect --bf16 on 16 PNG frames, against detect_batch
        frames_dir = os.path.join(d, "frames")
        os.makedirs(frames_dir)
        rng = np.random.default_rng(16)
        frames = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(16)]
        names = [f"f{i:02d}.png" for i in range(len(frames))]
        for name, im in zip(names, frames):
            with open(os.path.join(frames_dir, name), "wb") as f:
                f.write(encode_png(im))
        det_dir = os.path.join(d, "det")
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        run_cli(["detect", "--cfg", cfg, "--weights", w_path, "--bf16", "--images", frames_dir,
                 "--batch", "8", "--save-json", "--det", det_dir, "--reso", str(SIZE)])
        launched = dict(kernels.LAUNCHES)
        bf16 = Detector.load(cfg, w_path, device=dev, dtype=torch.bfloat16, precision="default")
        n_conv = len(bf16.model.convs)
        if not (launched["conv_bf16"] == 2 * n_conv and launched["decode_score"] == 2
                and launched["nms_keep"] == 2):
            fail(f"cli detect --bf16: expected {n_conv} K5 launches and one K1 and one K2 a "
                 f"batch of 8, two batches: {launched}")
        decoded = [decode_image(open(os.path.join(frames_dir, n), "rb").read()) for n in names]
        if not all(np.array_equal(a, b) for a, b in zip(decoded, frames)):
            fail("the PNG encoder's frames do not decode to the frames written")
        ref = (bf16.detect_batch(np.stack(decoded[:8]), size=SIZE)
               + bf16.detect_batch(np.stack(decoded[8:]), size=SIZE))
        got = jsonl_dets(os.path.join(det_dir, "detections.jsonl"))
        for i, (a, b) in enumerate(zip(got, ref)):
            if not (np.array_equal(a.cls_id, b.cls_id)
                    and np.abs(a.boxes - b.boxes).max(initial=0.0) <= 0.01 + 1e-4):
                fail(f"cli detect frame {i} differs from detect_batch: {a.cls_id} vs {b.cls_id}")
        drawn = [n for n in sorted(os.listdir(det_dir)) if n.startswith("det_")]
        if len(drawn) != 16 or any(decode_image(open(os.path.join(det_dir, n), "rb").read())
                                   is None for n in drawn):
            fail(f"cli detect wrote {len(drawn)} det_*.png files, or one does not decode")
        say(f"phase 16b cli detect --bf16, 16 PNG frames in batches of 8: equal to detect_batch "
            f"({sum(len(x) for x in got)} dets, same ids, boxes within 0.01), "
            f"{len(drawn)} det_*.png decode; launches {launched}")
        del bf16

        # c. evaluate: the fp32 detector's own detections as the ground truth,
        # at 384x512, the 480x640 frames' own aspect: at 416 a quarter of the
        # canvas is letterbox padding, and a box a random-weight head centres
        # there clamps to zero height, which the evaluator (as pycocotools)
        # gives IoU 0 with itself, so such a set could not score 1.0
        conf, reso = 0.3, EVAL_RESO
        fp32 = Detector.load(cfg, w_path, device=dev)
        dets = fp32.detect_many(decoded, size=reso, conf=conf, batch=8, transfer="u8")
        images, anns = [], []
        for i, (name, det) in enumerate(zip(names, dets)):
            images.append({"id": i, "file_name": name, "width": 640, "height": 480})
            for box, c in zip(det.boxes.astype(np.float64), det.cls_id):
                anns.append({"id": len(anns), "image_id": i, "category_id": COCO_IDS[int(c)],
                             "bbox": [box[0], box[1], box[2] - box[0], box[3] - box[1]],
                             "iscrowd": 0})
        if len(anns) < 50:
            fail(f"the self-set holds {len(anns)} boxes, fewer than 50")
        ann_path = os.path.join(d, "instances.json")
        with open(ann_path, "w", encoding="utf-8") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": [{"id": c, "name": str(c)} for c in COCO_IDS]}, f)
        ev = ["evaluate", "--cfg", cfg, "--weights", w_path, "--images", frames_dir,
              "--annotations", ann_path, "--confidence", str(conf), "--batch", "8",
              "--reso", f"{reso[0]}x{reso[1]}"]
        r32 = json.loads(run_cli(ev).strip().splitlines()[-1])
        if not (r32["mAP@0.5"] >= 0.999 and r32["AP@[.5:.95]"] >= 0.999):
            fail(f"evaluate of the fp32 detector on its own set: {r32}")
        r16 = json.loads(run_cli(ev + ["--bf16"]).strip().splitlines()[-1])
        out["evaluate"] = {"boxes": len(anns), "fp32": r32, "bf16": r16}
        say(f"phase 16c cli evaluate --reso {reso[0]}x{reso[1]}, fp32 detections of 16 frames as "
            f"the set ({len(anns)} boxes, conf {conf}): fp32 mAP@0.5 {r32['mAP@0.5']}, "
            f"AP@[.5:.95] {r32['AP@[.5:.95]']}; --bf16 mAP@0.5 {r16['mAP@0.5']}, AP@[.5:.95] "
            f"{r16['AP@[.5:.95]']} (not gated; phase 11 live bf16 set agreement "
            f"{bf16_drift:.3f})")
        window = decoded * (EVAL_WINDOW // len(decoded))
        rates: dict = {b: [] for b in EVAL_BATCHES}
        for b in EVAL_BATCHES:
            fp32.detect_many(window[:b], size=SIZE, conf=conf, batch=b, transfer="u8")  # warm
        for _ in range(WINDOWS):
            for b in EVAL_BATCHES:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fp32.detect_many(window, size=SIZE, conf=conf, batch=b, transfer="u8")
                rates[b].append(len(window) / (time.perf_counter() - t0))
        out["detect_many_u8_img_s"] = {b: spread(v) for b, v in rates.items()}
        best = max(EVAL_BATCHES, key=lambda b: out["detect_many_u8_img_s"][b]["median"])
        out["best_batch"] = best
        say(f"phase 16c fp32 detect_many u8 at {SIZE}, {len(window)} 480x640 frames, {WINDOWS} "
            f"windows in "
            f"turns, img/s median (runs): "
            + "; ".join(f"batch {b} {r['median']:.1f} ({r['runs']})"
                        for b, r in out["detect_many_u8_img_s"].items())
            + f"; best batch {best} (evaluate --batch default {cli.EVAL_BATCH}); on {card}")
        del fp32

        # d. profile --pipeline and profile, bf16 batch 128
        common = ["--cfg", cfg, "--weights", w_path, "--bf16", "--batch", str(BATCH),
                  "--reso", str(SIZE)]
        pipe = json.loads(run_cli(["profile", "--pipeline"] + common).strip().splitlines()[-1])
        stages = json.loads(run_cli(["profile"] + common).strip().splitlines()[-1])
        nms_cum = pipe[-1]["cum_ms"]
        fwd = next(r["delta_ms"] for r in pipe if r["stage"] == "+forward")
        out["profile_pipeline"], out["profile_stages"] = pipe, stages
        say(f"phase 16d cli profile --pipeline --bf16 batch {BATCH}: {json.dumps(pipe)}")
        say(f"phase 16d cli profile --bf16 batch {BATCH}: {json.dumps(stages)}")
        if not abs(nms_cum / ms6 - 1.0) <= 0.15:
            fail(f"profile +nms cum {nms_cum} ms is not within 15 % of phase 6's {ms6:.3f}")
        if not abs(stages[-1]["cum_ms"] / fwd - 1.0) <= 0.10:
            fail(f"profile stages end at {stages[-1]['cum_ms']} ms, not within 10 % of the "
                 f"+forward delta {fwd}")
        say(f"phase 16d gates: +nms cum {nms_cum:.3f} ms vs phase 6 {ms6:.3f} "
            f"({nms_cum / ms6 - 1:+.1%}); stages' last cum {stages[-1]['cum_ms']:.3f} vs +forward "
            f"delta {fwd:.3f} ({stages[-1]['cum_ms'] / fwd - 1:+.1%}); on {card}")

        # e. int8 through the command line: calibrate and write, then reload
        calib_dir = os.path.join(d, "calib")
        os.makedirs(calib_dir)
        for i in range(4):
            im = np.random.default_rng(100 + i).integers(0, 256, (480, 640, 3), dtype=np.uint8)
            with open(os.path.join(calib_dir, f"c{i}.png"), "wb") as f:
                f.write(encode_png(im))
        scales = os.path.join(d, "scales.json")
        int8_runs, t_int8 = [], []
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        for run in range(2):
            out_dir = os.path.join(d, f"int8_{run}")
            t0 = time.perf_counter()
            run_cli(["detect", "--cfg", cfg, "--weights", w_path, "--int8", "--bf16",
                     "--int8-calib", calib_dir, "--int8-scales", scales, "--images", frames_dir,
                     "--batch", "8", "--save-json", "--det", out_dir, "--reso", str(SIZE)])
            t_int8.append(time.perf_counter() - t0)
            int8_runs.append(jsonl_dets(os.path.join(out_dir, "detections.jsonl")))
        launched = dict(kernels.LAUNCHES)
        st = detection_drift(int8_runs[0], int8_runs[1])
        recipe = json.load(open(scales, encoding="utf-8")).get("recipe")
        if not (st.ref_dets > 0 and st.set_agreement == 1.0):
            fail(f"cli int8 calibrate-then-reload: {st.row()}")
        if not (launched["int8_gemm"] and launched["int8_conv"]) or (
                launched["int8_gemm_mma"] or launched["int8_conv_mma"]):
            fail(f"cli int8: expected K3 and K4 on the wgmma core only: {launched}")
        say(f"phase 16e cli detect --int8 --bf16 --int8-calib (recipe {recipe}) then reload "
            f"--int8-scales: {t_int8[0]:.1f} s / {t_int8[1]:.1f} s, the two runs {st.row()}; "
            f"launches {launched}")

        # f. batched_nms on the 85-column rows, card against CPU
        bf16 = Detector.load(cfg, w_path, device=dev, dtype=torch.bfloat16, precision="default")
        x = letterbox_batch(torch.from_numpy(np.stack(decoded[:8])).to(dev), SIZE)
        with torch.no_grad():
            rows = decode_all(bf16.model(x), v3).to(torch.float32).contiguous()
        del bf16
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        res = batched_nms(rows, CONF, IOU, MAX_DET)
        torch.cuda.synchronize()
        launched = dict(kernels.LAUNCHES)
        cpu = batched_nms(rows.cpu(), CONF, IOU, MAX_DET)
        if launched["nms_keep"] != 1:
            fail(f"batched_nms on the card: expected one K2 launch: {launched}")
        keep = res.valid.cpu()
        box_err = max_err(res.boxes.cpu()[keep], cpu.boxes[keep]) if bool(keep.any()) else 0.0
        if not (torch.equal(keep, cpu.valid) and torch.equal(res.cls_id.cpu(), cpu.cls_id)
                and box_err <= 1e-5 and bool(keep.any())):
            fail(f"batched_nms card vs CPU: keep equal {torch.equal(keep, cpu.valid)}, "
                 f"{int(keep.sum())} kept, box err {box_err}")
        say(f"phase 16f batched_nms on {tuple(rows.shape)} rows (yolov3@{SIZE} bf16, plain decode "
            f"widened to fp32), batch 8: one K2 launch, keep sets equal to the CPU's "
            f"({int(keep.sum())} kept), boxes within {box_err:.3g}")

        # g. the module runner in subprocesses, on the built kernel library
        built = os.path.getmtime(kernels.LIBRARY)
        for argv in (["info", "--cfg", cfg, "--int8-plan"],
                     ["detect", "--cfg", cfg, "--weights", w_path, "--bf16", "--images",
                      os.path.join(frames_dir, names[0]), "--det", os.path.join(d, "one"),
                      "--reso", str(SIZE)]):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "pytorch_yolo_tpu_torch", *argv],
                                  cwd=root, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                fail(f"python -m pytorch_yolo_tpu_torch {argv[0]} exited {proc.returncode}: "
                     f"{proc.stderr[-2000:]}")
            say(f"phase 16g python -m pytorch_yolo_tpu_torch {argv[0]}: exit 0 in "
                f"{time.perf_counter() - t0:.1f} s")
        if os.path.getmtime(kernels.LIBRARY) != built:
            fail("the module runner rebuilt the kernel library")
    finally:
        tmp.cleanup()
    return out


def skewed_frames(n: int = 8):
    """n 480x640 frames: frame 3 over the whole range, the others dim (< 24),
    so the shards of a mesh see different maxima."""
    rng = np.random.default_rng(17)
    x = rng.integers(0, 24, (n, 480, 640, 3), dtype=np.uint8)
    x[3] = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    return x


def bit_equal(ref, ours) -> bool:
    return len(ref) == len(ours) and all(
        len(a) == len(b) and all(np.array_equal(getattr(a, f), getattr(b, f))
                                 for f in ("boxes", "obj", "cls_score", "cls_id"))
        for a, b in zip(ref, ours))


def box_gap(ref, ours) -> float:
    """The largest |box difference| between two runs' detections, image by
    image and row by row (inf where the counts differ)."""
    gap = 0.0
    for a, b in zip(ref, ours):
        if len(a) != len(b):
            return float("inf")
        if len(a):
            gap = max(gap, float(np.abs(a.boxes - b.boxes).max()))
    return gap


def phase17_mesh(kernels, v3, live, tiny_spec, tiny_live, frames, dev, card) -> dict:
    """The batch mesh: a mesh of two entries of cuda:0 (and of every card,
    where there are more) against the detector without a mesh."""
    import threading

    from pytorch_yolo_tpu_torch import Detection, Detector
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch
    from pytorch_yolo_tpu_torch.parallel import make_batch_mesh
    from pytorch_yolo_tpu_torch.serve import MicroBatcher
    from pytorch_yolo_tpu_torch.utils.drift import detection_drift

    current = torch.cuda.current_device()
    bf = dict(dtype=torch.bfloat16, precision="default")
    out: dict = {}
    single = Detector(v3, live, device=dev, **bf)

    def one_step(det):
        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        res = det.raw_result(frames, size=SIZE, conf=CONF, iou=IOU, max_det=MAX_DET)
        torch.cuda.synchronize()
        return res, dict(kernels.LAUNCHES)

    ref_res, ref_launches = one_step(single)
    ref = single._trim(ref_res, BATCH)

    def against_single(devices, tag):
        """17a/17e: yolov3@416 live bf16 at batch 128 on a mesh over
        ``devices``: agreement 1.0 with the meshless step, the launches of
        one step once a shard."""
        mesh = Detector(v3, live, mesh=make_batch_mesh(devices), **bf)
        res, launched = one_step(mesh)
        check_result(res, f"mesh {tag}")
        if res.boxes.device != dev:
            fail(f"mesh {tag}: the result lies on {res.boxes.device}, not on {dev}")
        m = len(devices)
        if any(launched[k] != m * ref_launches[k] for k in launched):
            fail(f"mesh {tag}: launches {launched}, expected {m} x the meshless step's "
                 f"{ref_launches}")
        ours = mesh._trim(res, BATCH)
        st = detection_drift(ref, ours)
        if not (st.ref_dets > 0 and st.set_agreement == 1.0):
            fail(f"mesh {tag} vs meshless: {st.row()}")
        say(f"phase 17 yolov3@{SIZE} live bf16 batch {BATCH} on a mesh of {tag}: "
            f"{st.row()}; largest box difference {box_gap(ref, ours):.6g} px, bit-equal "
            f"{bit_equal(ref, ours)}; launches {launched} ({m} x {ref_launches})")
        return mesh, {"agree": st.set_agreement, "box_gap_px": box_gap(ref, ours),
                      "bit_equal": bit_equal(ref, ours), "launches": launched}

    # 17a: two entries of cuda:0
    mesh, out["17a"] = against_single([dev, dev], f"2 entries of {dev}")

    # 17b: dynamic int8 (bf16 glue: every other conv on K5, which gives the
    # same bits at any batch) on a skewed batch: the scale is the whole batch's
    kw = dict(quant="w8a8", **bf)
    t_single = Detector(tiny_spec, tiny_live, device=dev, **kw)
    t_mesh = Detector(tiny_spec, tiny_live, mesh=make_batch_mesh([dev, dev]), **kw)
    skew = skewed_frames()
    first = min(map(int, t_mesh.model.qconvs))
    x = letterbox_batch(torch.from_numpy(skew).to(dev), SIZE)
    local = [float(t_mesh.model(x[i:i + 4], collect_conv_in_stats=lambda j, v: v.abs().amax()
                                if j == first else None)[1][first]) for i in (0, 4)]
    if local[0] == local[1]:
        fail(f"17b: the skewed batch's shards have one maximum {local} at conv {first}")
    t_ref = t_single.detect_batch(skew, size=SIZE, conf=0.3)
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    t_ours = t_mesh.detect_batch(skew, size=SIZE, conf=0.3)
    torch.cuda.synchronize()
    launched = dict(kernels.LAUNCHES)
    int8 = {k: launched[k] for k in ("int8_gemm", "int8_conv", "int8_gemm_mma", "int8_conv_mma",
                                     "int8_conv_packed")}
    if (sum(int8.values()) != 2 * len(t_mesh.model.qconvs) or not launched["int8_gemm"]
            or not launched["int8_conv"] or any(v % 2 for v in int8.values())):
        fail(f"17b: expected every int8 conv on K3/K4 once a shard: {launched}")
    if not (sum(len(d) for d in t_ref) > 0 and bit_equal(t_ref, t_ours)):
        fail(f"17b: dynamic int8 on the mesh differs from meshless "
             f"(largest box difference {box_gap(t_ref, t_ours)})")
    shard_scaled = [d for i in (0, 4) for d in t_single.detect_batch(skew[i:i + 4], size=SIZE,
                                                                     conf=0.3)]
    say(f"phase 17b yolov3-tiny@{SIZE} live w8a8 dynamic (bf16 glue), skewed batch of 8 on 2 "
        f"entries: shards' max|x| at conv {first} {local[0]:.6g} / {local[1]:.6g}; bit-equal to "
        f"meshless ({sum(len(d) for d in t_ours)} dets); int8 launches {int8}; a scale per "
        f"shard instead would give agreement {detection_drift(t_ref, shard_scaled).set_agreement:.3f}")
    out["17b"] = {"local_max": local, "bit_equal": True, "int8_launches": int8}
    del t_single, t_mesh

    # 17c: ragged batch, detect_many u8, detect_stream and a MicroBatcher of floor 2
    mix = np.random.default_rng(71)
    imgs = [mix.integers(0, 256, shp + (3,), dtype=np.uint8)
            for shp in ((480, 640), (300, 500), (640, 480), (123, 777), (720, 1280))] * 2
    five = np.stack([im for im in imgs if im.shape[:2] == (480, 640)] * 5)[:5]
    checks = {
        "ragged 5 -> 6": (single.detect_batch(five, size=SIZE, conf=CONF),
                          mesh.detect_batch(five, size=SIZE, conf=CONF)),
        "detect_many u8, 10 mixed in chunks of 4": (
            single.detect_many(imgs, size=SIZE, conf=CONF, batch=4, transfer="u8"),
            mesh.detect_many(imgs, size=SIZE, conf=CONF, batch=4, transfer="u8")),
        "detect_stream, 5 mixed, host letterbox u8": (
            list(single.detect_stream(iter(imgs[:5]), size=SIZE, conf=CONF, host_preproc=True,
                                      transfer="u8")),
            list(mesh.detect_stream(iter(imgs[:5]), size=SIZE, conf=CONF, host_preproc=True,
                                    transfer="u8"))),
        "detect_stream, 3 frames": (
            list(single.detect_stream(iter(list(five[:3])), size=SIZE, conf=CONF)),
            list(mesh.detect_stream(iter(list(five[:3])), size=SIZE, conf=CONF))),
    }
    batcher = MicroBatcher(mesh, SIZE, CONF, IOU, batch_max=3, batch_timeout_ms=20.0)
    try:
        if (batcher.bucket_floor, batcher.batch_max) != (2, 4):
            fail(f"17c: MicroBatcher on 2 entries: floor {batcher.bucket_floor}, batch_max "
                 f"{batcher.batch_max}; expected 2 and 4")
        pend: list = [None] * 5
        threads = [threading.Thread(target=lambda i=i, im=im: pend.__setitem__(i, batcher.submit(im)))
                   for i, im in enumerate(imgs[:5])]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        for p in pend:
            if p is None or not p.event.wait(timeout=120) or p.error is not None:
                fail(f"17c: a MicroBatcher request failed: {None if p is None else p.error}")
    finally:
        batcher.close()
    served = [Detection(boxes=np.asarray(p.result["boxes"], np.float32).reshape(-1, 4),
                        obj=np.asarray(p.result["obj"], np.float32),
                        cls_score=np.asarray(p.result["cls_score"], np.float32),
                        cls_id=np.asarray(p.result["cls_id"], np.int32)) for p in pend]
    alone = [single.detect_many([im], size=SIZE, conf=CONF, iou=IOU, batch=1, transfer="u8")[0]
             for im in imgs[:5]]
    checks["MicroBatcher floor 2, 5 concurrent requests"] = (alone, served)
    out["17c"] = {}
    for name, (a, b) in checks.items():
        st = detection_drift(a, b)
        if not (st.ref_dets > 0 and st.set_agreement == 1.0 and len(a) == len(b)):
            fail(f"17c {name}: mesh vs meshless {st.row()}")
        out["17c"][name] = {"agree": st.set_agreement, "box_gap_px": box_gap(a, b),
                            "bit_equal": bit_equal(a, b)}
        say(f"phase 17c yolov3@{SIZE} live bf16, {name}: mesh vs meshless {st.row()}, largest "
            f"box difference {box_gap(a, b):.6g} px, bit-equal {bit_equal(a, b)}")

    # 17d: ms/batch, meshless and mesh in turns (a reading, not a gate)
    def step_of(det):
        return lambda: det.raw_result(frames, size=SIZE, conf=CONF, iou=IOU, max_det=MAX_DET)

    turns = [time_ms(step_of(d), iters=10) for d in (single, mesh, mesh, single)]
    out["17d"] = {"meshless_ms": [turns[0], turns[3]], "mesh_ms": [turns[1], turns[2]]}
    say(f"phase 17d yolov3@{SIZE} live bf16 batch {BATCH} ms/batch in turns (meshless, mesh of 2 "
        f"entries of {dev}, mesh, meshless): {turns[0]:.3f} / {turns[1]:.3f} / {turns[2]:.3f} / "
        f"{turns[3]:.3f}; mesh {(turns[1] + turns[2]) / (turns[0] + turns[3]) - 1:+.2%} on {card}")
    del mesh

    # 17e: every card, where there is more than one
    count = torch.cuda.device_count()
    if count > 1:
        _, out["17e"] = against_single([torch.device("cuda", i) for i in range(count)],
                                       f"{count} cards")
    else:
        say("phase 17e: one card (torch.cuda.device_count() == 1): only the one-card mesh ran")
    if torch.cuda.current_device() != current:
        fail(f"phase 17 moved the current device from {current} to {torch.cuda.current_device()}")
    return out


def lap(tag: str) -> None:
    """Mark the start of a phase: its wall time runs to the next mark."""
    LAPS.append((tag, time.perf_counter()))


def phase_seconds() -> dict:
    """Wall seconds of each phase, from the marks of :func:`lap`."""
    ends = [t for _, t in LAPS[1:]] + [time.perf_counter()]
    return {tag: round(end - t, 2) for (tag, t), end in zip(LAPS, ends)}


def profile_rows(step, top: int = 8) -> dict:
    """One call of ``step`` under torch.profiler, after one it records
    nothing of (without that warm-up, a process that has profiled before
    lost the window's first kernels): device ms by kernel (the ``top``
    largest, names cut to 90 characters), the device operations (kernels,
    memsets, copies) and their total device ms."""
    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    done: list = []  # the recorded step's events, read when its trace is ready
    with torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(
            wait=0, warmup=1, active=1), on_trace_ready=lambda p: done.append(
                p.key_averages())) as prof:
        for _ in range(2):
            step()
            torch.cuda.synchronize()
            prof.step()
    rows, ops = [], 0
    for evt in done[0]:
        if (evt.device_type != torch.autograd.DeviceType.CUDA
                or evt.key.startswith("ProfilerStep")):  # the step's own span
            continue
        ops += evt.count
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0.0)
        rows.append((us / 1e3, evt.count, evt.key[:90]))
    rows.sort(reverse=True)
    return dict(device_ms=sum(r[0] for r in rows), operations=ops,
                top=[dict(ms=round(ms, 4), launches=n, kernel=k) for ms, n, k in rows[:top]])


def big_cats(fn) -> int:
    """The ``aten::cat`` calls ``fn`` runs whose output is an activation-
    sized float tensor, a route's copy (a TorchDispatchMode sees the
    tensors; the profiler records no shapes for a tensor list)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    calls = []

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if (func is torch.ops.aten.cat.default and out.is_floating_point()
                    and out.numel() >= 1 << 16):
                calls.append(tuple(out.shape))
            return out

    with Watch():
        fn()
    return len(calls)


def int8_forward_ops(det, xin, what: str) -> dict:
    """The aten ops of an int8 detector's forward on activation-sized
    tensors (``torch.profiler`` with record_shapes; the ``cat``s by
    :func:`big_cats`): it fails on a ``div``,
    ``round`` or ``clamp`` (K6 quantizes, K3/K4 requantize), on an ``add``
    that is not an unfused [shortcut], on a [shortcut] after an int8 conv
    that is not in its epilogue, and on a ``cat`` of a multi-source route
    whose next layer is an int8 conv (its K6 reads the sources)."""
    model = det.model
    layers = det.spec.layers
    shortcuts = [l.index - 1 for l in layers if type(l).__name__ == "ShortcutSpec"]
    fused_q = sorted(i for i in model._fused if i in model._qconv_at)
    if fused_q != sorted(i for i in shortcuts if i in model._qconv_at):
        fail(f"{what}: the [shortcut]s after int8 convs {shortcuts} are not all fused: "
             f"{fused_q}")
    unfused = [i for i in shortcuts if i not in model._fused]
    with torch.no_grad():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                    record_shapes=True) as prof:
            model(xin, _native_heads=True)
    big: dict = {}
    for evt in prof.events():
        if any(int(np.prod(sh)) >= 1 << 16 for sh in (evt.input_shapes or [])
               if sh and all(isinstance(d, int) for d in sh)):
            big[evt.name] = big.get(evt.name, 0) + 1
    glue = {k: big.get(f"aten::{k}", 0) for k in ("div", "round", "clamp", "add", "abs",
                                                   "_to_copy", "copy_")}
    with torch.no_grad():
        glue["cat"] = big_cats(lambda: model(xin, _native_heads=True))
    if glue["div"] or glue["round"] or glue["clamp"] or glue["add"] != len(unfused):
        fail(f"{what} forward: activation-sized aten ops {glue}; expected no div, round or "
             f"clamp and {len(unfused)} adds (unfused shortcuts {unfused})")
    routes = sorted(l.index for l in layers
                    if type(l).__name__ == "RouteSpec" and len(l.layers) > 1)
    into_int8 = [r for r in routes if r + 1 in model._qconv_at]
    if sorted(model._read_through) != into_int8 or glue["cat"] != len(routes) - len(into_int8):
        fail(f"{what} forward: {glue['cat']} activation-sized torch.cat for the concat routes "
             f"{routes}; those before an int8 conv {into_int8} must all be read through by its "
             f"K6 (read through: {sorted(model._read_through)})")
    return dict(glue=glue, shortcuts=shortcuts, fused_q=fused_q, unfused=unfused, routes=routes,
                read_through=into_int8)


def path_int8_vs_plain(kernels, fn, what: str) -> dict:
    """Every K3/K4/K6 call of ``fn`` (one int8 forward), each held against
    its plain version on the same inputs as it returns: the kernel's real
    inputs and output at the path's shapes.  K6 and an int8 output must be
    equal (0 int8 steps), an fp32 output within 1e-6 of the larger of |out|
    and |[shortcut] operand|, as phase 7.  Returns, for each wrapper, its
    calls, worst error and the configurations it saw (shapes, branches,
    split groups, activation, [shortcut], strided branches)."""
    plain = {"int8_gemm": lambda xq, wq, _mma=False, **epi: kernels.gemm_i8_ref(xq, wq, **epi),
             "int8_conv": lambda xq, wq, stride, pad, _mma=False, **epi: kernels.int8_conv_ref(
                 xq, wq, stride, pad, **epi),
             "quantize_i8": kernels.quantize_i8_ref}
    real = {name: getattr(kernels, name) for name in plain}
    seen = {name: {"calls": 0, "max_err": 0.0, "configs": set()} for name in plain}

    def spy(name):
        def call(*args, **kw):
            out = real[name](*args, **kw)
            ref = plain[name](*args, **kw)
            if name == "quantize_i8":
                xs = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
                config = (tuple(xs[0].shape[:-1]), tuple((t.shape[-1], str(t.dtype)[6:],
                                                          t.is_contiguous()) for t in xs))
                lim = torch.zeros((), device=out.device)
            else:
                sc = kw.get("shortcut")
                config = (tuple(args[0].shape), tuple(args[1].shape), tuple(args[2:4]),
                          kw.get("activation"), kw.get("splits"),
                          None if sc is None else str(sc.dtype)[6:], str(ref.dtype)[6:])
                lim = (torch.zeros((), device=out.device) if ref.dtype != torch.float32
                       else 1e-6 * (ref.abs() if sc is None else torch.maximum(
                           ref.abs(), sc.float().reshape(ref.shape).abs())))
            if out.dtype != ref.dtype or out.shape != ref.shape:
                fail(f"{what}: {name} {config} gives {out.dtype} {tuple(out.shape)}, its plain "
                     f"version {ref.dtype} {tuple(ref.shape)}")
            gap = abs_diff(out.float(), ref.float())  # int8 widened: its steps
            if not bool((gap <= lim).all()):
                fail(f"{what}: {name} {config} disagrees with its plain version on the path's "
                     f"inputs (max abs err {float(gap.max()):.3g})")
            s = seen[name]
            s["calls"] += 1
            s["max_err"] = max(s["max_err"], float(gap.max()))
            s["configs"].add(config)
            return out
        return call

    try:
        for name in plain:
            setattr(kernels, name, spy(name))
        with torch.no_grad():
            fn()
    finally:
        for name, f in real.items():
            setattr(kernels, name, f)
    return seen


def worst_match(ref, ours, match_px: float = 8.0) -> float:
    """The largest box difference (px) of a detection of ``ours`` from its
    nearest detection of ``ref`` within ``match_px``, over all images."""
    worst = 0.0
    for a, b in zip(ref, ours):
        if len(a) and len(b):
            d = np.abs(b.boxes[:, None, :] - a.boxes[None, :, :]).max(-1).min(1)
            d = d[d <= match_px]
            if d.size:
                worst = max(worst, float(d.max()))
    return worst


def k5_cases(kernels, det, x, tag: str, all_acts=None, per_step=None) -> tuple:
    """K5 against its plain version on every distinct conv of bf16
    detector ``det`` on the letterboxed batch ``x`` (each conv's real
    input, taken by a stats hook), with its own activation (every
    activation at the shape ``all_acts``, an (input shape, weight shape)
    key), and the first conv that takes a [shortcut] with a random
    operand (where the model has one).  Returns the worst case (equal
    share, steps, abs error), the number of cases, and each distinct conv's
    first layer and input; ``per_step`` (a dict) counts the convs of each
    (input HWC, weight shape, stride) a step."""
    keys: dict = {}

    def hook(i, t):
        c = det.model.convs[str(i)]
        key = (tuple(t.shape), tuple(c.weight.shape), c.stride, c.padding, c.activation)
        if per_step is not None:
            shape = (tuple(t.shape[1:]), tuple(c.weight.shape), c.stride)
            per_step[shape] = per_step.get(shape, 0) + 1
        if key in keys:
            return None
        keys[key] = i
        return t.to(torch.bfloat16).contiguous()

    with torch.no_grad():
        _, inputs = det.model(x, collect_conv_in_stats=hook)
    cases = []
    for key, i in keys.items():
        c = det.model.convs[str(i)]
        acts = ["leaky", "mish", "relu", "logistic", "linear"] if key[:2] == all_acts else [
            c.activation]
        for act in acts:
            cases.append((f"{tag} conv {i} {key[0]} * {key[1]} s{c.stride} {act}", inputs[i], c,
                          act, None))
    if det.model._fused:  # the v2 pair has no [shortcut]
        fused = min(det.model._fused)
        c = det.model.convs[str(fused)]
        xf = inputs.get(fused)
        if xf is None:  # the first conv of its shape is another layer: take that layer's input
            k = next(k for k, j in keys.items() if k[1] == tuple(c.weight.shape)
                     and k[2:4] == (c.stride, c.padding))
            xf = inputs[keys[k]]
        sc_shape = (xf.shape[0],
                    (xf.shape[1] + 2 * c.padding - c.weight.shape[1]) // c.stride + 1,
                    (xf.shape[2] + 2 * c.padding - c.weight.shape[2]) // c.stride + 1,
                    c.weight.shape[0])
        sc = torch.randn(sc_shape, device=xf.device).to(torch.bfloat16)
        cases.append((f"{tag} conv {fused} {c.activation} + shortcut", xf, c, c.activation, sc))
    worst = {"equal": 1.0, "steps": 0, "abs": 0.0}
    for name, xc, c, act, sc in cases:
        before = kernels.LAUNCHES["conv_bf16"]
        ours = kernels.conv_bf16(xc, c.weight, c.bias, c.stride, c.padding, act, sc)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["conv_bf16"] != before + 1:
            fail(f"K5 {name}: expected one launch, counts {kernels.LAUNCHES}")
        ref = kernels.conv_bf16_ref(xc, c.weight, c.bias, c.stride, c.padding, act, sc)
        equal, steps, err = k5_agreement(ours, ref, xc, c.weight, c.bias, c.stride, c.padding,
                                         sc)
        worst = {"equal": min(worst["equal"], equal), "steps": max(worst["steps"], steps),
                 "abs": max(worst["abs"], err)}
        if ours.shape != ref.shape or equal < 0.999 or steps > 1:
            fail(f"K5 {name}: {equal:.5%} bit-equal, {steps} bf16 steps beyond the sum's order "
                 f"error (gate >= 99.9 %, <= 1)")
        say(f"phase 13 K5 {name}: ok, {equal:.4%} bit-equal, <= {steps} bf16 step beyond the "
            f"order error, max abs err {err:.3g}")
        del ours, ref
    return worst, len(cases), keys, inputs


def phase19_yolov4_tiny(kernels, frames, frames4, calib, dev, card) -> dict:
    """yolov4-tiny@416: live fp32 card vs CPU; bf16 and int8sb (the ladder:
    early skip 0, split routes, the int8 maxpool chain) at batch 128; int8sb
    card vs the CPU serving the card's quant_state()."""
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.models.zoo import model_spec
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch
    from pytorch_yolo_tpu_torch.utils.drift import detection_drift
    from pytorch_yolo_tpu_torch.weights import (equalize_raw_params, fold_batchnorm,
                                                random_raw_params)

    spec = model_spec(V4_TINY)
    bf16 = dict(dtype=torch.bfloat16, precision="default")
    live = fold_batchnorm(spec, equalize_raw_params(spec, random_raw_params(spec), device=dev))
    out: dict = {}
    gpu = Detector(spec, live, device=dev, precision="highest").detect_batch(
        frames4, size=SIZE, conf=0.5, iou=IOU, max_det=MAX_DET)
    cpu = Detector(spec, live, device="cpu", precision="highest").detect_batch(
        frames4, size=SIZE, conf=0.5, iou=IOU, max_det=MAX_DET)
    st = detection_drift(cpu, gpu)
    if not (st.ref_dets > 0 and st.set_agreement == 1.0):
        fail(f"yolov4-tiny@{SIZE} live fp32 card vs CPU: {st.row()}")
    out["fp32_card_vs_cpu"] = st.set_agreement
    say(f"phase 19 yolov4-tiny@{SIZE} live fp32 highest, 4 frames, card vs CPU: {st.row()}; "
        f"worst matched box {worst_match(cpu, gpu):.4g} px")

    def run(det, what):
        def step():
            return det.raw_result(frames, size=SIZE, conf=CONF, iou=IOU, max_det=MAX_DET)

        kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
        times, res = pipeline_ms(step)
        launches = dict(kernels.LAUNCHES)
        steps = len(times) + 3
        model = det.model
        stem = sum(1 for q in model.qconvs.values() if q.wq.shape[-1] == 3)  # the RGB stem
        want = dict(decode_score=steps, nms_keep=steps, conv_bf16=len(model.convs) * steps,
                    quantize_i8=(len(model.qconvs) - len(model._chains)) * steps, absmax=0,
                    int8_conv_packed=stem * steps, int8_gemm_mma=0, int8_conv_mma=0)
        n_int8 = sum(launches[k] for k in ("int8_gemm", "int8_conv", "int8_gemm_mma",
                                           "int8_conv_mma", "int8_conv_packed"))
        if (any(launches[k] != v for k, v in want.items())
                or n_int8 != len(model.qconvs) * steps):
            fail(f"yolov4-tiny {what}: launches {launches}, expected {want}, "
                 f"{len(model.qconvs)} K3/K4 a step ({stem} on the packed route: C = 3; none "
                 f"on mma.sync)")
        check_result(res, f"yolov4-tiny {what}")
        ms = statistics.median(times)
        prof = profile_rows(step)
        say(f"phase 19 yolov4-tiny@{SIZE} {what} batch {BATCH} pipeline: median {ms:.3f} "
            f"ms/batch, {BATCH / ms * 1e3:.1f} img/s (min {min(times):.3f}, max "
            f"{max(times):.3f}) on {card}; launches {launches}; under torch.profiler "
            f"{prof['device_ms']:.3f} ms of {prof['operations']} device operations, top "
            f"kernels {json.dumps(prof['top'][:6])}")
        return dict(ms=ms, img_s=BATCH / ms * 1e3, launches=launches, profile=prof)

    out["bf16"] = run(Detector(spec, live, device=dev, **bf16), "bf16")
    if out["bf16"]["launches"]["conv_bf16"] != 21 * 23:
        fail(f"yolov4-tiny bf16: expected 21 K5 launches a step: {out['bf16']['launches']}")
    det8 = Detector(spec, live, device=dev, quant="w8a8", quant_calib=calib,
                    quant_calib_size=SIZE, quant_recipe="none", **bf16)
    out["int8sb"] = run(det8, "int8sb")
    with torch.no_grad():
        ops = int8_forward_ops(det8, letterbox_batch(frames, SIZE), "yolov4-tiny int8sb")
    splits = [l.index for l in spec.layers
              if type(l).__name__ == "RouteSpec" and l.groups > 1]
    xin = letterbox_batch(frames, SIZE)
    path8 = path_int8_vs_plain(kernels, lambda: det8.model(xin, _native_heads=True),
                               "yolov4-tiny int8sb")
    # the stride-2 int8 RGB stem alone, on the packed route and on mma.sync
    out["int8_stem"] = int8_stem(kernels, det8, xin, card, "phase 19 yolov4-tiny")
    del xin
    calls = {k: v["calls"] for k, v in path8.items()}
    n_quant = len(det8.model.qconvs) - len(det8.model._chains)
    if (calls["int8_gemm"] + calls["int8_conv"] != len(det8.model.qconvs)
            or calls["quantize_i8"] != n_quant):
        fail(f"yolov4-tiny int8sb: the forward held against the plain versions made {calls} "
             f"calls ({len(det8.model.qconvs)} K3/K4, {n_quant} K6 expected)")
    strided = sorted(c for c in path8["quantize_i8"]["configs"] if not all(b[2] for b in c[1]))
    say(f"phase 19 yolov4-tiny int8sb forward at batch {BATCH}, every K3/K4/K6 call held "
        f"against its plain version on its real inputs: "
        + "; ".join(f"{k} {v['calls']} calls, {len(v['configs'])} configurations, max abs err "
                    f"{v['max_err']:.3g}" for k, v in path8.items())
        + f"; K6 on strided branches (split routes' channel slices) {strided}")
    say(f"phase 19 yolov4-tiny int8sb: {len(det8.model.qconvs)} int8 convs, int8-resident "
        f"links {det8.model._chains}, split routes {splits} (channel slices read in place by "
        f"K6), concat routes {ops['routes']} read through {ops['read_through']}; "
        f"activation-sized aten ops {ops['glue']}")
    state = json.loads(json.dumps(det8.quant_state()))
    det_cpu = Detector(spec, live, device="cpu", quant="w8a8", quant_act_scales=state["scales"],
                       quant_skip_layers=frozenset(state["skip"]), **bf16)
    gpu = det8.detect_batch(frames4, size=SIZE, conf=0.5, iou=IOU, max_det=MAX_DET)
    st = detection_drift(det_cpu.detect_batch(frames4, size=SIZE, conf=0.5, iou=IOU,
                                              max_det=MAX_DET), gpu)
    if not (st.ref_dets > 0 and st.set_agreement >= 0.995):
        fail(f"yolov4-tiny int8sb card vs CPU on the card's state: {st.row()}")
    out["int8sb_card_vs_cpu"] = st.set_agreement
    say(f"phase 19 yolov4-tiny@{SIZE} live int8sb card vs the CPU serving the card's "
        f"quant_state(): set agreement {st.set_agreement:.4f} (>= 0.995); {st.row()}")
    del det8, det_cpu
    torch.cuda.empty_cache()
    return out


# phases 18 and 20-27: what each model must launch, from its generator's
# shapes (tests/test_torch_csp.py, tests/test_torch_large.py and
# tests/test_torch_zoo_v2_spp.py: test_family_plans): bf16 convs (each on
# K5), int8sb's K3 and K4 convs (default skip) and those of them on the
# packed route (the C = 3 RGB stem of a ladder family; none runs on the
# mma.sync core), the multi-source
# route whose sources one K6 reads (SPP's four, or yolov2's reorg route 28;
# None: the model has no such route) and the int8 convs after a concat
# route, on split groups with quant_split_concat.  boxed / halo: the bf16
# convs on K5's "im2col16" / halo routes (C % 32 != 0; every model's RGB
# stem runs on K5's packed route, and none on the gather); padded / c32: the
# bf16 convs with C % 64 == 32 on K5's "im2col_pad" route (C > 32) and on
# its "im2col32" route (C = 32).  drift_guarded: a
# degenerate drift row is printed "DO-NOT-BANK" instead of failing the phase
# (yolov3-spp, whose live regime was degenerate on the TPU).
MODEL_PLAN = {"yolov4": dict(convs=110, k3=52, k4=37, route=113, split=8, c32=2),
              "yolov4-csp": dict(convs=115, k3=61, k4=37, route=109, split=13, c32=2),
              "yolov4x-mish": dict(convs=139, k3=72, k4=48, route=133, split=13, boxed=6,
                                   padded=17),
              "yolov4-p5": dict(convs=163, k3=82, k4=58, route=169, split=13, c32=2),
              "yolov4-p6": dict(convs=205, k3=81, k4=53, route=197, split=15, c32=2),
              "yolov4-p7": dict(convs=247, k3=73, k4=45, route=225, split=15, boxed=5, halo=1,
                                padded=23),
              "yolov3-spp": dict(convs=76, k3=32, k4=31, route=83, split=3, c32=2,
                                 drift_guarded=True),
              "yolov2": dict(convs=23, k3=7, k4=15, route=28, split=1, packed=1, c32=1),
              "yolov2-tiny": dict(convs=9, k3=0, k4=8, route=None, split=0, packed=1,
                                  boxed=1, c32=1)}


def pool_times(spec, size: int, batch: int, dev, dtype, layers=None) -> dict:
    """Each maxpool of ``spec`` (or those of ``layers``) alone, device ms
    from a CUDA graph, at its input: ``batch`` random maps of its channels
    on the grid of the stride at the pool, bf16 or resident int8."""
    from pytorch_yolo_tpu_torch.config import MaxPoolSpec
    from pytorch_yolo_tpu_torch.models.darknet import _maxpool
    from pytorch_yolo_tpu_torch.ops.quant import _layer_input_strides

    in_stride = _layer_input_strides(spec)
    out = {}
    for layer in spec.layers:
        if not isinstance(layer, MaxPoolSpec) or (layers is not None
                                                  and layer.index not in layers):
            continue
        grid = size // in_stride[layer.index]
        shape = (batch, spec.out_channels[layer.index - 1], grid, grid)
        if dtype == torch.int8:
            x = torch.randint(-127, 128, shape, dtype=torch.int8, device=dev)
        else:
            x = torch.randn(shape, device=dev).to(dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        pool = lambda layer=layer, x=x: _maxpool(x, layer)  # noqa: E731
        out[f"layer {layer.index} {layer.size}x{layer.size} s{layer.stride} {grid}²"] = \
            graph_ms(pool)
        del x
    return out


def int8_stem(kernels, det, xin, card, tag: str) -> dict:
    """The int8 RGB stem of a ladder family alone, on its real inputs (the
    int8 of the letterboxed batch ``xin`` and the stem's epilogue, taken
    from one forward): K4's packed route, which the plan picks, and the
    ``mma.sync`` core (``_mma=True``, the byte path it replaced), each one
    launch and equal to the plain version; their device times in turns from
    CUDA graphs (mma.sync, packed, packed, mma.sync), the packed route's
    eager time, its bound, its plain version, K5 on the same conv in bf16
    (the bf16 path's stem) and cuDNN's bf16 ``F.conv2d`` + bias + leaky
    (device times in turns with the packed route)."""
    F = torch.nn.functional
    real = kernels.int8_conv
    seen: list = []

    def spy(xq, wq, stride, pad, **kw):
        if not seen and xq.shape[-1] == 3:
            seen.append((xq, wq, stride, pad, kw))
        return real(xq, wq, stride, pad, **kw)

    try:
        kernels.int8_conv = spy
        with torch.no_grad():
            det.model(xin, _native_heads=True)
    finally:
        kernels.int8_conv = real
    xq, wq, stride, pad, kw = seen[0]
    plan = kernels.igemm_plan(3, [0, 3], wq.shape[0], False, True, wq.shape[1], wq.shape[2],
                              stride, pad)
    ref = kernels.int8_conv_ref(xq, wq, stride, pad, **kw)
    outs = {}
    for key, mma in (("int8_conv_packed", False), ("int8_conv_mma", True)):
        before = dict(kernels.LAUNCHES)
        outs[key] = real(xq, wq, stride, pad, _mma=mma, **kw)
        torch.cuda.synchronize()
        if kernels.LAUNCHES != {**before, key: before[key] + 1}:
            fail(f"{tag}: the int8 RGB stem {tuple(xq.shape)} -> {wq.shape[0]} (plan {plan}) "
                 f"expected one {key} launch: {kernels.LAUNCHES}")
        if not torch.equal(outs[key], ref):
            fail(f"{tag}: the int8 stem on {key} disagrees with its plain version")
    if plan[0] != "packed":
        fail(f"{tag}: the int8 RGB stem is not on the packed route: plan {plan}")
    out = outs.pop("int8_conv_packed")
    del outs, ref
    k4 = lambda: real(xq, wq, stride, pad, **kw)  # noqa: E731
    old = lambda: real(xq, wq, stride, pad, _mma=True, **kw)  # noqa: E731
    ms = time_ms(k4)
    dev_ms, mma_ms = in_turns(old, k4, timer=graph_ms)
    plain_ms = time_ms(lambda: kernels.int8_conv_ref(xq, wq, stride, pad, **kw), 2, 1)
    # the same conv in bf16: K5 (packed route) and cuDNN, on the fp32 input
    xb = xin.to(torch.bfloat16).contiguous()
    wb = (wq.float() * kw["ws"][:, None, None, None]).to(torch.bfloat16).contiguous()
    k5 = lambda: kernels.conv_bf16(xb, wb, kw["b"], stride, pad, "leaky")  # noqa: E731
    xc = xb.permute(0, 3, 1, 2)
    wc = wb.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    bc = kw["b"].to(torch.bfloat16)
    lib = lambda: F.leaky_relu(F.conv2d(xc, wc, bc, stride=stride, padding=pad),  # noqa: E731
                               0.1, inplace=True)
    dev2_ms, lib_ms = in_turns(lib, k4, timer=graph_ms)
    k5_ms = graph_ms(k5)
    ops, nbytes = kernels.igemm_work(tuple(xq.shape), tuple(wq.shape), stride, pad,
                                     out.element_size())
    bms, by = bound(ops, nbytes, PEAK_INT8_OPS)
    res = dict(shape=list(xq.shape), out_channels=wq.shape[0], stride=stride,
               out_dtype=str(out.dtype)[6:], plan=list(plan), max_abs_err=0.0, ms=ms,
               device_ms=dev_ms, device_ms_vs_cudnn=dev2_ms, mma_device_ms=mma_ms,
               plain_ms=plain_ms, k5_bf16_device_ms=k5_ms, cudnn_bf16_device_ms=lib_ms,
               bound_ms=bms, bound_by=by)
    say(f"{tag} int8 RGB stem alone ({tuple(xq.shape)} -> {wq.shape[0]}, 3x3 s{stride}, "
        f"{str(out.dtype)[6:]} out, the forward's own inputs): K4's packed route {ms:.4f} ms "
        f"eager, {dev_ms:.4f} ms device ({bms / dev_ms:.2%} of its {bms:.4f} ms bound, {by}: "
        f"{ops / 1e9:.1f} G ops, {nbytes / 1e6:.1f} MB); the mma.sync core {mma_ms:.4f} ms "
        f"device in turns ({mma_ms / dev_ms:.1f}x); cuDNN bf16 conv + bias + leaky {lib_ms:.4f} "
        f"ms device in turns (packed {dev2_ms:.4f}); K5 bf16 (packed) {k5_ms:.4f} ms device; "
        f"plain {plain_ms:.2f} ms; both cores int8 equal to the plain version; on {card}")
    del out, xb, wb, xc, wc
    return res


def double(det, name, size, batch, part, res, frames, phase, dev, out, tag) -> None:
    """(d) of :func:`phase_model`: bf16 at twice the batch once, every field
    of the result bit-equal to the two halves (``res`` the first half's),
    the peak memory printed; frames past ``frames`` are drawn from seed
    ``phase``."""
    more = frames[batch:2 * batch]
    if len(more) < batch:  # the second half from its own seed
        more = torch.cat([more, torch.from_numpy(np.random.default_rng(phase).integers(
            0, 256, size=(batch - len(more), *frames.shape[1:]), dtype=np.uint8)).to(dev)])
    torch.cuda.reset_peak_memory_stats(dev)
    both = frames[:2 * batch] if len(frames) >= 2 * batch else torch.cat([part, more])
    whole = det.raw_result(both, size=size, conf=CONF, iou=IOU, max_det=MAX_DET)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    second = det.raw_result(more, size=size, conf=CONF, iou=IOU, max_det=MAX_DET)
    check_result(whole, f"{name} bf16 batch {2 * batch}", 2 * batch)
    differ = [f for f in whole._fields
              if not torch.equal(getattr(whole, f), torch.cat([getattr(res, f),
                                                               getattr(second, f)]))]
    if differ:
        fail(f"{name} bf16 batch {2 * batch}: {differ} differ from the two batch-{batch} halves")
    c0 = det.model.convs["0"]
    elems = 2 * batch * size ** 2 * c0.weight.shape[0]
    out[f"batch{2 * batch}"] = dict(bit_equal=True, peak_gb=peak / 1e9, layer0_elements=elems)
    say(f"{tag}d {name}@{size} bf16 batch {2 * batch} once: every field bit-equal to the "
        f"two batch-{batch} halves; layer 0's output {elems:,} elements "
        f"({elems / 2 ** 31:.1%} of 2^31, {2 * elems / 1e9:.2f} GB); peak memory "
        f"{peak / 1e9:.2f} GB")
    del whole, second, more, both


def phase_model(kernels, phase, name, size, batch, spec, live, info, frames, calib, dev,
                card) -> dict:
    """A model of :data:`MODEL_PLAN` at full width on its live weights
    ``live`` (``info``: the equalizer's report), batch ``batch`` at
    ``size``: (a) fp32 card vs CPU; (b) bf16 and (c) int8sb, ms/batch,
    launches and profiler rows, the maxpools timed alone (bf16, and int8
    where int8sb keeps them resident), every K3/K4/K6 call held against its
    plain version, the int8 RGB stem alone on a ladder family; (d) bf16 at
    twice the batch, bit-equal to its halves (frames past ``frames`` drawn
    from seed ``phase``) where ``frames`` holds both halves or layer 0's
    output stays under 2^31 elements; (e) drift of bf16 and int8sb "auto"
    against fp32."""
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch
    from pytorch_yolo_tpu_torch.utils.drift import detection_drift, measure_mode_drift

    plan = MODEL_PLAN[name]
    packed = plan.get("packed", 0)
    route = plan["route"]
    tag = f"phase {phase}"
    bf16 = dict(dtype=torch.bfloat16, precision="default")
    out: dict = {}
    # (a) fp32 "highest", card vs CPU (phase 10 holds Detector.load's
    # synthetic="live" to the same equalized weights on the card; running
    # the equalizer again a model cost ~150 s a run)
    frames2 = frames[:2].cpu().numpy()
    det_ref = Detector(spec, live, device=dev, precision="highest")
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    gpu = det_ref.detect_batch(frames2, size=size, conf=0.5, iou=IOU, max_det=MAX_DET)
    torch.cuda.synchronize()
    launches_a = dict(kernels.LAUNCHES)
    if not (launches_a["decode_score"] == 1 and launches_a["nms_keep"] == 1):
        fail(f"{name} fp32 detect_batch: expected one K1 and one K2 launch: {launches_a}")
    t0 = time.perf_counter()
    cpu = Detector(spec, live, device="cpu", precision="highest").detect_batch(
        frames2, size=size, conf=0.5, iou=IOU, max_det=MAX_DET)
    cpu_s = time.perf_counter() - t0
    st = detection_drift(cpu, gpu)
    if not (st.ref_dets > 0 and st.set_agreement >= 0.995):
        fail(f"{name}@{size} live fp32 card vs CPU: {st.row()}")
    if not all(np.isfinite(d.boxes).all() and d.boxes.shape[1:] == (4,) for d in gpu):
        fail(f"{name} fp32 detections are not finite (M, 4) boxes")
    out["fp32_card_vs_cpu"] = dict(agree=st.set_agreement, worst_px=worst_match(cpu, gpu),
                                   dets=st.ref_dets)
    say(f"{tag}a {name}@{size} live weights: equalizer {info['sweeps']} sweeps (largest "
        f"|log std| {info['max_log_std']:.4f}) in {info['seconds']:.1f} s on the card; fp32 "
        f"highest, 2 frames, card vs CPU: set agreement {st.set_agreement:.4f} (>= 0.995), "
        f"worst matched box {out['fp32_card_vs_cpu']['worst_px']:.4g} px; {st.row()}; the "
        f"CPU took {cpu_s:.1f} s; launches {launches_a}")
    del gpu, cpu

    # (b) bf16: every conv on K5
    part = frames[:batch]
    det = Detector(spec, live, device=dev, **bf16)

    def step():
        return det.raw_result(part, size=size, conf=CONF, iou=IOU, max_det=MAX_DET)

    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    kernels.CONV_BF16_LAUNCHES.update(dict.fromkeys(kernels.CONV_BF16_LAUNCHES, 0))
    times, res = pipeline_ms(step)
    launches = dict(kernels.LAUNCHES)
    k5_routes = dict(kernels.CONV_BF16_LAUNCHES)
    steps = len(times) + 3
    if not (launches["decode_score"] == steps and launches["nms_keep"] == steps):
        fail(f"{name} bf16: expected one K1 and one K2 launch in each of {steps} steps: "
             f"{launches}")
    if (len(det.model.convs) != plan["convs"]
            or launches["conv_bf16"] != plan["convs"] * steps):
        fail(f"{name} bf16: expected one K5 launch for each of {plan['convs']} convs in each of "
             f"{steps} steps ({len(det.model.convs)} convs): {launches}")
    if (k5_routes["im2col16"] != plan.get("boxed", 0) * steps
            or k5_routes["halo"] != plan.get("halo", 0) * steps or k5_routes["gather"]
            or k5_routes["packed"] != steps
            or k5_routes["im2col_pad"] != plan.get("padded", 0) * steps
            or k5_routes["im2col32"] != plan.get("c32", 0) * steps):
        fail(f"{name} bf16: expected {plan.get('boxed', 0)} K5 launch(es) a step on the "
             f"\"im2col16\" route, {plan.get('halo', 0)} on the halo route, "
             f"{plan.get('padded', 0)} on the \"im2col_pad\" route, {plan.get('c32', 0)} on "
             f"the \"im2col32\" route, the stem on the packed route and none on the gather "
             f"route in each of {steps} steps: {k5_routes}")
    check_result(res, f"{name} bf16", batch)
    bf16_dets = det._trim(res, batch)
    ms = statistics.median(times)
    prof = profile_rows(step)
    # the maxpools (F.max_pool2d, as the JAX package computes them outside
    # Pallas: SPP's three stride-1 pools, the v2 ladders' 2x2 pools) at
    # their input, bf16, on the grid of the stride at the pool
    pools = pool_times(spec, size, batch, dev, torch.bfloat16)
    out["bf16"] = dict(ms=ms, img_s=batch / ms * 1e3, min=min(times), max=max(times),
                       launches=launches, k5_routes=k5_routes, profile=prof,
                       pools_device_ms=pools)
    say(f"{tag}b {name}@{size} bf16 batch {batch} pipeline: median {ms:.3f} ms/batch, "
        f"{batch / ms * 1e3:.1f} img/s (min {min(times):.3f}, max {max(times):.3f} ms; "
        f"{int(res.valid.sum())} kept) on {card}; launches {launches}; K5 by route "
        f"{k5_routes}")
    say(f"{tag}b {name} bf16 step under torch.profiler: {prof['device_ms']:.3f} ms of "
        f"{prof['operations']} device operations; top kernels {json.dumps(prof['top'])}; "
        f"maxpools alone (bf16, batch {batch}, device ms) {json.dumps(pools, ensure_ascii=False)}")

    # (d) bf16 at twice the batch once, bit-equal to the two halves: where
    # ``frames`` holds both, or layer 0's output stays under 2^31 elements
    # (yolov4-csp@512 at 256 would reach it)
    if (len(frames) >= 2 * batch
            or 2 * batch * size ** 2 * det.model.convs["0"].weight.shape[0] < 2 ** 31):
        double(det, name, size, batch, part, res, frames, phase, dev, out, tag)
    del res, det


    # (c) int8sb: static scales from 4 frames calibrated at the model's size
    t0 = time.perf_counter()
    det = Detector(spec, live, device=dev, quant="w8a8", quant_calib=calib,
                   quant_calib_size=size, quant_recipe="none", **bf16)
    cal_s = time.perf_counter() - t0
    model = det.model

    def step8():
        return det.raw_result(part, size=size, conf=CONF, iou=IOU, max_det=MAX_DET)

    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    times8, res8 = pipeline_ms(step8)
    launches8 = dict(kernels.LAUNCHES)
    n_quant = len(model.qconvs) - len(model._chains)
    if (launches8["int8_gemm_mma"] + launches8["int8_conv_mma"]
            or launches8["int8_conv_packed"] != packed * steps):
        fail(f"{name} int8sb: expected {packed} int8 conv(s) a step on K4's packed route (the "
             f"C = 3 RGB stem of a ladder family) and none on the mma.sync core: {launches8}")
    if not (launches8["decode_score"] == steps and launches8["nms_keep"] == steps):
        fail(f"{name} int8sb: expected one K1 and one K2 launch a step: {launches8}")
    if (launches8["int8_gemm"] + launches8["int8_gemm_mma"] != plan["k3"] * steps
            or launches8["int8_conv"] + launches8["int8_conv_packed"] != plan["k4"] * steps
            or len(model.qconvs) != plan["k3"] + plan["k4"]
            or launches8["conv_bf16"] != len(model.convs) * steps
            or len(model.convs) + len(model.qconvs) != plan["convs"]
            or launches8["quantize_i8"] != n_quant * steps or launches8["absmax"]):
        fail(f"{name} int8sb: expected {plan['k3']} K3, {plan['k4']} K4, "
             f"{plan['convs'] - plan['k3'] - plan['k4']} K5 and {n_quant} K6 launches a step "
             f"and no absmax ({len(model.qconvs)} int8 convs): {launches8}")
    with torch.no_grad():
        ops8 = int8_forward_ops(det, letterbox_batch(part, size), f"{name} int8sb")
    srcs = () if route is None else tuple(spec.layers[route].layers)
    if route is not None and route not in ops8["read_through"]:
        fail(f"{name} int8sb: route {route} is not read through: {ops8['read_through']}")
    xin = letterbox_batch(part, size)
    path8 = path_int8_vs_plain(kernels, lambda: model(xin, _native_heads=True),
                               f"{name} int8sb")
    # the int8 pools (resident int8 between a chain's producer and consumer)
    # and the int8 RGB stem of a ladder family, alone
    int8_pools = {j for p, c in model._chains.items() for j in range(p + 1, c)}
    pools8 = pool_times(spec, size, batch, dev, torch.int8, int8_pools) if int8_pools else {}
    stem = int8_stem(kernels, det, xin, card, f"{tag}c {name}") if packed else None
    del xin
    route_k6 = sorted(c for c in path8["quantize_i8"]["configs"]
                      if tuple(b[0] for b in c[1]) == tuple(spec.out_channels[j] for j in srcs))
    if (path8["int8_gemm"]["calls"] + path8["int8_conv"]["calls"] != len(model.qconvs)
            or path8["quantize_i8"]["calls"] != n_quant or (route is not None and not route_k6)):
        calls = {k: v["calls"] for k, v in path8.items()}
        fail(f"{name} int8sb: the forward held against the plain versions made {calls} calls "
             f"({len(model.qconvs)} K3/K4, {n_quant} K6 expected), route {route}'s "
             f"{len(srcs)}-source K6 {route_k6}")
    # quant_split_concat: each concat source at its own scale, the convs
    # after a concat summing split groups
    det_sg = Detector(spec, live, device=dev, quant="w8a8", quant_calib=calib,
                      quant_calib_size=size, quant_recipe="none", quant_split_concat=True,
                      **bf16)
    xin = letterbox_batch(part, size)
    path_sg = path_int8_vs_plain(kernels, lambda: det_sg.model(xin, _native_heads=True),
                                 f"{name} int8sb split-concat")
    del xin
    split_convs = sorted(det_sg.model._split_groups)
    groups = sorted({c[4] for k in ("int8_gemm", "int8_conv") for c in path_sg[k]["configs"]
                     if c[4] is not None})
    n_split = sum(1 for i in det_sg.model._qconv_at
                  if det_sg.model._scale_args(i)[1] is not None)
    del det_sg
    want_groups = tuple(spec.out_channels[j] for j in srcs)
    route_sg = sorted(c for k in ("int8_gemm", "int8_conv") for c in path_sg[k]["configs"]
                      if route is not None and c[4] == want_groups)
    if n_split != plan["split"] or (route is not None and not route_sg):
        fail(f"{name} int8sb split-concat: {n_split} int8 convs on split groups "
             f"({plan['split']} expected), groups {groups}; conv after route {route} on split "
             f"groups {want_groups}: {route_sg}")
    check_result(res8, f"{name} int8sb", batch)
    drift8 = detection_drift(bf16_dets, det._trim(res8, batch))
    ms8 = statistics.median(times8)
    prof8 = profile_rows(step8)
    out["int8sb"] = dict(ms=ms8, img_s=batch / ms8 * 1e3, min=min(times8), max=max(times8),
                         launches=launches8, profile=prof8, int8_convs=len(model.qconvs),
                         bf16_convs=len(model.convs), chains=len(model._chains),
                         drift_vs_bf16=drift8.set_agreement, calibrate_s=cal_s,
                         aten=ops8["glue"], int8_pools_device_ms=pools8, int8_stem=stem,
                         vs_plain={k: dict(calls=v["calls"], configs=len(v["configs"]),
                                           max_err=v["max_err"]) for k, v in path8.items()},
                         split_concat_vs_plain={k: dict(calls=v["calls"], max_err=v["max_err"])
                                                for k, v in path_sg.items()},
                         split_groups=[list(g) for g in groups])
    say(f"{tag}c {name}@{size} int8sb (w8a8, bf16 glue, {len(model.qconvs)} int8 convs, "
        f"{packed} on the packed route, {len(model.convs)} on K5, {len(model._chains)} "
        f"int8-resident links, static scales from 4 frames at {size}) batch {batch} pipeline: "
        f"median "
        f"{ms8:.3f} ms/batch, {batch / ms8 * 1e3:.1f} img/s (min {min(times8):.3f}, max "
        f"{max(times8):.3f} ms; load+calibrate {cal_s:.1f} s) on {card}; bf16 {ms:.3f} "
        f"ms/batch; launches {launches8}")
    say(f"{tag}c {name} int8sb forward under torch.profiler: activation-sized aten ops "
        f"{ops8['glue']} (no div/round/clamp; {len(ops8['fused_q'])} of "
        f"{len(ops8['shortcuts'])} [shortcut]s in K3/K4's epilogue, the rest in K5's; unfused "
        f"{ops8['unfused']}); routes {ops8['routes']}, read through by K6 {ops8['read_through']} "
        f"(route {route}: sources {list(srcs)}, one K6 launch)")
    say(f"{tag}c {name} int8sb step under torch.profiler: {prof8['device_ms']:.3f} ms of "
        f"{prof8['operations']} device operations; top kernels {json.dumps(prof8['top'])}; "
        f"int8 maxpools alone (resident int8, batch {batch}, device ms) "
        f"{json.dumps(pools8, ensure_ascii=False)}")
    say(f"{tag}c {name} int8sb forward at batch {batch}, every K3/K4/K6 call held against "
        f"its plain version on its real inputs: "
        + "; ".join(f"{k} {v['calls']} calls, {len(v['configs'])} configurations, max abs err "
                    f"{v['max_err']:.3g}" for k, v in path8.items())
        + f" (int8 and K6 equal, fp32 within 1e-6 of max(|out|, |operand|)); route "
        f"{route} K6 {route_k6[0] if route_k6 else None} int8 equal; K3/K4 input channels "
        f"{sorted({c[0][-1] for k in ('int8_gemm', 'int8_conv') for c in path8[k]['configs']})}")
    say(f"{tag}c {name} int8sb with quant_split_concat at batch {batch}, held the same way: "
        + "; ".join(f"{k} {v['calls']} calls, max abs err {v['max_err']:.3g}"
                    for k, v in path_sg.items())
        + f"; {n_split} int8 convs on split groups {groups} (convs after a concat "
        f"{split_convs}); the conv after route {route} on split groups "
        f"{route_sg[0][:5] if route_sg else None}")
    say(f"{tag}c drift int8sb vs bf16 (live weights, not gated): {drift8.row()}")
    del det, res8, model

    # (e) live drift of bf16 and int8sb "auto" against fp32, 4 frames
    img_rng = np.random.default_rng(0)
    drift_imgs = [img_rng.integers(0, 256, (480, 640, 3), dtype=np.uint8) for _ in range(4)]
    calib_live = [np.random.default_rng(100 + i).integers(0, 256, (480, 640, 3), dtype=np.uint8)
                  for i in range(4)]
    rows = {}
    for mode, kw in (("bf16", bf16),
                     ("int8sb auto", dict(quant="w8a8", quant_calib=calib_live,
                                          quant_calib_size=size, **bf16))):
        det = Detector(spec, live, device=dev, **kw)
        st = measure_mode_drift(det_ref, det, drift_imgs, size=size)
        if st.degenerate and not plan.get("drift_guarded"):
            fail(f"{name} drift {mode}: degenerate regime: {st.row()}")
        rows[mode] = dict(agree=st.set_agreement, box_p99=st.box_p99_px, score_p99=st.score_p99,
                          degenerate=st.degenerate,
                          recipe=det.quant_state().get("recipe") if det.quant else None)
        say(f"{tag}e drift {name}@{size} live, {mode} vs fp32 highest: {st.row()}"
            + (" DO-NOT-BANK (a degenerate regime, printed and not gated on this model)"
               if st.degenerate else ""))
        del det
    out["drift"] = rows
    del det_ref
    torch.cuda.empty_cache()
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "pytorch_yolo_tpu_torch", "csrc")):
        fail(f"no pytorch_yolo_tpu_torch/ beside {__file__}: run it from a checkout")
    sys.path.insert(0, root)  # the checkout's package, not an installed one
    from pytorch_yolo_tpu_torch import Detector
    from pytorch_yolo_tpu_torch.config import head_strides, load_model_spec
    from pytorch_yolo_tpu_torch.models.zoo import model_spec
    from pytorch_yolo_tpu_torch.ops import kernels
    from pytorch_yolo_tpu_torch.ops.decode import head_decode_args
    from pytorch_yolo_tpu_torch.ops.nms import fixpoint_rounds, iou_matrix
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch
    from pytorch_yolo_tpu_torch.utils.drift import detection_drift

    cfg = os.path.join(root, "cfg", "yolov3.cfg")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)

    # 1. the card
    lap("1")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "--id=0"], capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    kind = torch.cuda.get_device_name(0)
    say(f"phase 1 card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda} "
        f"| {kind} x{torch.cuda.device_count()}")

    # 2. build
    lap("2")
    t0 = time.perf_counter()
    kernels.build(force=True)
    kernels.load_library()
    say(f"phase 2 build: {time.perf_counter() - t0:.2f} s ({kernels.LIBRARY})")

    # 3. K1 against its plain version
    lap("3")
    v3 = load_model_spec(cfg)
    heads_v3 = [(f"yolov3 {SIZE // s}x{SIZE // s}", (8, SIZE // s, SIZE // s, 255), h, s, False)
                for h, s in zip(v3.yolo_layers, head_strides(v3))]
    v2 = load_model_spec(os.path.join(root, "cfg", "yolov2.cfg"))
    p5 = load_model_spec(os.path.join(root, "cfg", "yolov4-p5.cfg"))
    extra = [("yolov2 region softmax 13x13", (8, 13, 13, 425), v2.yolo_layers[0],
              head_strides(v2)[0], False),
             ("yolov4-p5 4-anchor new_coords 52x52", (8, 52, 52, 340), p5.yolo_layers[0],
              head_strides(p5)[0], True)]
    v4 = model_spec(V4)
    heads_v4 = [(f"yolov4 {V4_SIZE // s}x{V4_SIZE // s} scale_x_y {h.scale_x_y}",
                 (8, V4_SIZE // s, V4_SIZE // s, 255), h, s, False)
                for h, s in zip(v4.yolo_layers, head_strides(v4))]
    extra += heads_v4
    # the Scaled-YOLOv4 CSP family: three new_coords heads (scale_x_y 2.0) a
    # model, on values a logistic conv already squashed, at the published sizes
    csp_specs = {name: model_spec(name) for name, _, _ in CSP}
    heads_csp = {name: [(f"{name} {size // s}x{size // s} new_coords scale_x_y {h.scale_x_y}",
                         (8, size // s, size // s, 255), h, s, True)
                        for h, s in zip(csp_specs[name].yolo_layers,
                                        head_strides(csp_specs[name]))]
                 for name, size, _ in CSP}
    for heads in heads_csp.values():
        extra += heads
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
    heads4 = tuple(torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32))
                   .to(torch.bfloat16).to(dev) for _, shape, _, _, _ in heads_v4)
    before = dict(kernels.LAUNCHES)
    ours = kernels.decode_score_all(heads4, v4)
    torch.cuda.synchronize()
    if kernels.LAUNCHES != {**before, "decode_score": before["decode_score"] + 1}:
        fail(f"K1 on yolov4's three bf16 heads: expected one launch, counts {kernels.LAUNCHES}")
    err = max_err(ours, plain_rows(kernels, heads4, v4))
    if not rows_close(ours, plain_rows(kernels, heads4, v4)):
        fail(f"K1 bf16 yolov4 heads at {V4_SIZE}: kernel disagrees with its plain version ({err})")
    k1_err = max(k1_err, err)
    say(f"phase 3 K1 yolov4@{V4_SIZE} bf16 heads (scale_x_y "
        f"{[h.scale_x_y for h in v4.yolo_layers]}), batch 8, one launch: ok, max abs err "
        f"{err:.3g}")
    del heads4, ours
    for name, size, _ in CSP:
        hc = tuple(torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32))
                   .to(torch.bfloat16).to(dev) for _, shape, _, _, _ in heads_csp[name])
        k1_err = max(k1_err, k1_one_launch(kernels, name, size, csp_specs[name], hc))
        del hc
    # the Scaled-YOLOv4 large family: three, four or five new_coords heads of
    # four anchors (340 channels, values a logistic conv squashed) at the
    # published sizes (136,000 and 196,416 rows a frame on p6 and p7); then
    # the zoo's last three families: the [region] head of yolov2@416 and
    # yolov2-tiny@416 (five anchors in grid units, a softmax over 80 classes,
    # 845 rows a frame) and yolov3-spp@608's three [yolo] heads; each head
    # alone in fp32, then a model's bf16 heads in one launch; inputs from
    # their own generator, so the frames of the later phases stay those of
    # earlier runs
    large_specs = {name: model_spec(name) for name, _, _ in LARGE}
    last_specs = {name: model_spec(name) for name, _, _ in ZOO_LAST}
    rng3 = np.random.default_rng(3)
    for name, size, _ in LARGE + ZOO_LAST:
        spec = {**large_specs, **last_specs}[name]
        shapes = []
        for head, stride in zip(spec.yolo_layers, head_strides(spec)):
            anchors, cls_act, sxy, nc = head_decode_args(head, stride)
            shape = (8, size // stride, size // stride, len(anchors) * (5 + head.classes))
            shapes.append(shape)
            x = rng3.uniform(0, 1, shape) if nc else rng3.normal(0, 2, shape)
            raw = torch.from_numpy(x.astype(np.float32)).to(dev)
            kw = dict(cls_act=cls_act, scale_xy=sxy, new_coords=nc)
            ours = kernels.decode_score_head(raw, anchors, stride, head.classes, **kw)
            ref = kernels.decode_score_head_ref(raw, anchors, stride, head.classes, **kw)
            torch.cuda.synchronize()
            err = max_err(ours, ref)
            if not rows_close(ours, ref):
                fail(f"K1 {name} {shape[1]}x{shape[1]}: kernel disagrees with its plain version "
                     f"(max abs err {err})")
            k1_err = max(k1_err, err)
            say(f"phase 3 K1 {name} {type(head).__name__} {shape[1]}x{shape[1]} {len(anchors)} "
                f"anchors, classes {cls_act}, scale_x_y {sxy}, new_coords {nc} {shape}: ok, max "
                f"abs err {err:.3g} (tol {TOL} rel. to row corners; cls_id exact)")
            del raw, ours, ref
        hl = tuple(torch.from_numpy((rng3.uniform(0, 1, sh) if nc else rng3.normal(0, 2, sh))
                                    .astype(np.float32)).to(torch.bfloat16).to(dev)
                   for sh in shapes)
        k1_err = max(k1_err, k1_one_launch(kernels, name, size, spec, hl))
        del hl
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
    lap("4")
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
    lap("5")
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
    lap("6")
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
    if launches["conv_bf16"] != len(det.model.convs) * steps:
        fail(f"the bf16 main path: expected one K5 launch for each of {len(det.model.convs)} "
             f"convs in each of {steps} steps: {launches}")
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

    k2_bound, k2_by = nms_bound(valid, cls_f)
    k2_crowd_bound, _ = nms_bound(crowd[1], crowd[2])
    k2_chain_bound, _ = nms_bound(chain[1])
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
    lap("7")
    errs = {"int8_gemm": 0.0, "int8_conv": 0.0, "int8_conv_packed": 0.0}
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
            ("C=3 (the packed route; the byte path on mma.sync)", 3, 1, (2, 32, 32, 3), 16,
             "acc"),
            ("byte path K=24", 1, 1, (1, 16, 16, 24), 32, {"sx": "static", "act": "leaky"}),
            # four split groups (MAX_SPLIT_GROUPS): yolov4's conv 114 at 19² (608)
            ("split x4 19² 2048->512 mish", 1, 1, (8, 19, 19, 2048), 512,
             {"splits": (512,) * 4, "act": "mish"}),
            ("split x4 19² 2048->512 leaky int8 out", 1, 1, (8, 19, 19, 2048), 512,
             {"splits": (512,) * 4, "act": "leaky", "out": "vector"})]
    # the int8 RGB stem on K4's packed route (3x3, C = 3): the three zoo
    # stems at 416² and the route's edges, every epilogue mode it takes
    i8 = {"sx": "static", "act": "leaky", "out": "scalar"}
    packed = [("packed yolov2 stem s1 3->32 int8 out", 3, 1, (2, 416, 416, 3), 32, i8),
              ("packed yolov2-tiny stem s1 3->16 int8 out", 3, 1, (2, 416, 416, 3), 16, i8),
              ("packed yolov4-tiny stem s2 3->32 int8 out", 3, 2, (2, 416, 416, 3), 32, i8),
              ("packed int32 sums O=32", 3, 1, (2, 64, 64, 3), 32, "acc"),
              ("packed fp32 out static leaky O=8", 3, 1, (2, 64, 64, 3), 8,
               {"sx": "static", "act": "leaky"}),
              ("packed fp32 out dynamic mish O=24", 3, 1, (3, 37, 41, 3), 24,
               {"sx": "dynamic", "act": "mish"}),
              ("packed fp32 out per-channel sx logistic s2", 3, 2, (2, 33, 35, 3), 32,
               {"sx": "vector", "act": "logistic"}),
              ("packed int8 out per-channel out_scale linear O=16", 3, 1, (2, 29, 31, 3), 16,
               {"sx": "static", "act": "linear", "out": "vector"}),
              ("packed int8 in, int8 out mish O=24", 3, 1, (2, 30, 30, 3), 24,
               {"sx": "int8", "act": "mish", "out": "scalar"}),
              ("packed batch 1 417x415 s1 dynamic int8 out", 3, 1, (1, 417, 415, 3), 32,
               {"sx": "dynamic", "act": "leaky", "out": "scalar"}),
              ("packed batch 1 417x415 s2 (odd H and W) fp32 out", 3, 2, (1, 417, 415, 3), 16,
               {"sx": "static", "act": "leaky"}),
              ("packed tiles across 9 images of 7x5", 3, 1, (9, 7, 5, 3), 8, i8),
              ("packed one-pixel-wide images s2", 3, 2, (3, 9, 1, 3), 16, "acc")]
    cases = probe + [(f"{name} {m if isinstance(m, str) else m}", *v3_shapes[name], m)
                     for name in v3_shapes for m in modes[name]] + edge + packed
    cores = {"wgmma": 0, "mma": 0, "packed": 0}
    for name, k, stride, shape, o, mode in cases:
        xq, wq, st, pad, kw = int8_case(rng, k, stride, shape, o, mode, dev)
        ref = run_int8(kernels, xq, wq, st, pad, kw, plain=True)
        for mma in (False, True):
            key = int8_key(kernels, wq, st, kw, mma)
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
            if key.endswith("_packed"):  # the packed route: equal in every mode
                ok, what = ok and torch.equal(ours, ref), f"{what}; torch.equal"
            base_key = key.removesuffix("_mma")
            errs[base_key] = max(errs[base_key], err)
            cores[key.rpartition("_")[2] if key.endswith(("_mma", "_packed")) else "wgmma"] += 1
            if not ok:
                fail(f"{key} {name}: kernel disagrees with its plain version ({what}, {err})")
            say(f"phase 7 {key} {name} {tuple(shape)}->{o}: ok, {what}")
    say(f"phase 7: {len(cases)} cases, {cores['wgmma']} on the wgmma core, {cores['packed']} on "
        f"the packed route and {cores['mma']} on the mma.sync core, all equal to the plain "
        f"versions")

    # K3/K4 with a [shortcut] operand in the fp32 epilogue, on both cores
    sc_cases = [
        ("1x1 52² 256->128 leaky, fp32 operand", 1, 1, (8, 52, 52, 256), 128,
         {"sx": "static", "act": "leaky"}, torch.float32),
        ("3x3 s1 52² 128->256 mish, bf16 operand", 3, 1, (8, 52, 52, 128), 256,
         {"sx": "dynamic", "act": "mish"}, torch.bfloat16),
        ("3x3 s1 13² 512->1024 leaky (BN 256), bf16 operand", 3, 1, (8, 13, 13, 512), 1024,
         {"sx": "static", "act": "leaky"}, torch.bfloat16),
        ("1x1 O=42 mish (ragged rows), fp32 operand", 1, 1, (2, 26, 26, 64), 42,
         {"sx": "static", "act": "mish"}, torch.float32),
        ("3x3 s2 O=42 leaky (ragged rows), bf16 operand", 3, 2, (1, 27, 33, 48), 42,
         {"sx": "static", "act": "leaky"}, torch.bfloat16),
        ("split (128, 256) leaky, fp32 operand", 1, 1, (2, 26, 26, 384), 128,
         {"splits": (128, 256), "act": "leaky"}, torch.float32),
        ("byte path K=24 mish, bf16 operand", 1, 1, (1, 16, 16, 24), 32,
         {"sx": "static", "act": "mish"}, torch.bfloat16),
        ("split x4 19² 2048->512 mish, bf16 operand", 1, 1, (2, 19, 19, 2048), 512,
         {"splits": (512,) * 4, "act": "mish"}, torch.bfloat16)]
    for name, k, stride, shape, o, mode, sdt in sc_cases:
        xq, wq, st, pad, kw = int8_case(rng, k, stride, shape, o, mode, dev)
        check_shortcut(kernels, errs, "phase 7", name, xq, wq, st, pad, kw, sdt)
        del xq, wq, kw

    # K6: the quantizer and max|x| against their plain versions
    k6_err = k6_am_err = 0.0
    for name in K6_CASES:
        x, sx = k6_case(name, dev)
        xs, sc = k6_inputs(name, x, sx)
        before = dict(kernels.LAUNCHES)
        ours = kernels.quantize_i8(xs, sx)
        torch.cuda.synchronize()
        if kernels.LAUNCHES != {**before, "quantize_i8": before["quantize_i8"] + 1}:
            fail(f"K6 {name}: expected one quantize_i8 launch, counts {kernels.LAUNCHES}")
        ref = kernels.quantize_i8_ref(xs, sx)
        sx = sc
        q = (x.float() / sx).reshape(-1)
        ties, sat = int((q.frac().abs() == 0.5).sum()), int((q.abs() > 127.5).sum())
        # elements a multiply by the reciprocal would quantize the other way
        traps = int((torch.clamp(torch.round(x.float() * (1.0 / sx)), -127, 127).to(torch.int8)
                     != ref).sum())
        err = float((ours.long() - ref.long()).abs().max())
        k6_err = max(k6_err, err)
        if ours.dtype != torch.int8 or ours.shape != x.shape or err or not (ties and sat):
            fail(f"K6 {name}: {ours.dtype} {tuple(ours.shape)}, max difference {err}, "
                 f"{ties} ties, {sat} saturated")
        peak = 2.0 * float(x.float().abs().amax())
        x[(0,) * x.dim()] = -peak
        m = kernels.absmax(x.permute(0, 3, 1, 2) if name == "fp32 scalar" else x)
        torch.cuda.synchronize()
        k6_am_err = max(k6_am_err, abs(m.item() - kernels.absmax_ref(x).item()))
        if not m.item() == kernels.absmax_ref(x).item() == peak:
            fail(f"K6 absmax {name}: {m.item()} vs plain {kernels.absmax_ref(x).item()}, "
                 f"expected {peak}")
        say(f"phase 7 K6 {name} {tuple(x.shape)}: ok, int8 equal ({ties} exact ties, {sat} "
            f"past 127.5 s, {traps} a reciprocal would round otherwise); absmax bit-equal "
            f"({m.item():.6g})")
        del x, ours, ref, q

    # K6 over a route's sources (the read-through): one launch, the int8 of
    # the concatenation; a dynamic scale one absmax launch over the branches
    for name in K6_BRANCH_CASES:
        xs, sx = k6_branch_case(name, dev)
        before = dict(kernels.LAUNCHES)
        dyn = sx is None
        if dyn:
            sx = kernels.absmax(xs, scale=True)
        ours = kernels.quantize_i8(xs, sx)
        torch.cuda.synchronize()
        if kernels.LAUNCHES != {**before, "quantize_i8": before["quantize_i8"] + 1,
                                "absmax": before["absmax"] + dyn}:
            fail(f"K6 {name}: expected one K6 launch (and one absmax for a dynamic scale), "
                 f"counts {kernels.LAUNCHES}")
        ref = kernels.quantize_i8_ref(xs, sx)
        cat = torch.cat([t.float() for t in xs], -1)
        err = float((ours.long() - ref.long()).abs().max())
        k6_err = max(k6_err, err)
        if err or ours.shape != cat.shape:
            fail(f"K6 {name}: {tuple(ours.shape)}, max difference {err} from the plain version")
        if dyn and not torch.equal(sx, kernels.absmax(cat, scale=True)):
            fail(f"K6 {name}: the dynamic scale over the branches differs from the concat's")
        say(f"phase 7 K6 {name} {tuple(cat.shape)}: ok, one launch over "
            f"{len(xs)} sources, int8 equal to the plain version"
            + (", the dynamic scale over the branches equal to the concat's" if dyn else ""))
        del xs, ours, ref, cat

    # the quotient's bits over every bf16 and every fp32 pattern, and the
    # scale absmax writes against scale_of_amax of the plain max
    sweep7 = sweep_k6(kernels, dev)
    say(f"phase 7 K6 sweeps: every bf16 pattern and every fp32 pattern (2^32) at each of "
        f"{len(SWEEP_SCALES)} scales: int8 equal to the plain version; a multiply by the "
        f"reciprocal would differ on {sweep7['naive_differs']} fp32 patterns; "
        f"{sweep7['seconds']:.1f} s")
    from pytorch_yolo_tpu_torch.ops.quant import scale_of_amax

    ms7 = scale_sweep_values()
    for m in ms7:
        x = torch.tensor([[m / 2, -m, m / 4]], dtype=torch.float32, device=dev)
        got, want = kernels.absmax(x, scale=True), scale_of_amax(kernels.absmax_ref(x))
        if not torch.equal(got, want):
            fail(f"K6 dynamic scale at m = {m!r}: {got.item()!r} vs scale_of_amax {want.item()!r}")
    say(f"phase 7 K6 dynamic scale: fma(m, 1/127, eps) written by absmax equals scale_of_amax "
        f"for {len(ms7)} values of m (0, every power of two, subnormals)")

    # 8. int8 yolov3-tiny at fp32 glue: card against CPU.  Not 1.0: the fp32
    # head convs run in cuDNN on the card and in oneDNN on the CPU, and an
    # ulp of difference before a requant can move an int8 value by one step.
    lap("8")
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
    lap("9")
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
    if launches9["conv_bf16"] != len(det.model.convs) * (len(times9) + 3):
        fail(f"int8sb: expected one K5 launch for each of its {len(det.model.convs)} bf16 glue "
             f"convs a step: {launches9}")
    model9 = det.model
    ops9 = device_ops(step9)
    n_quant = len(model9.qconvs) - len(model9._chains)  # conv inputs not int8-resident
    if launches9["quantize_i8"] != n_quant * (len(times9) + 3) or launches9["absmax"]:
        fail(f"int8sb: expected {n_quant} K6 launches a step (one a conv input that is not "
             f"int8-resident) and no absmax (static scales): {launches9}")
    with torch.no_grad():
        xin = letterbox_batch(frames, SIZE)
        ops9f = int8_forward_ops(det, xin, "int8sb")
    glue, fused_q, shortcuts, unfused, routes = (ops9f[k] for k in (
        "glue", "fused_q", "shortcuts", "unfused", "routes"))
    if routes != ops9f["read_through"]:
        fail(f"int8sb: the concat routes {routes} must all be read through by their conv's K6 "
             f"(read through: {ops9f['read_through']})")
    say(f"phase 9 int8sb forward under torch.profiler: activation-sized aten ops {glue} "
        f"(no div/round/clamp; {len(fused_q)} of {len(shortcuts)} [shortcut]s in K3/K4's "
        f"epilogue, {len(shortcuts) - len(fused_q) - len(unfused)} in K5's, unfused "
        f"{unfused}); K6 launches {launches9['quantize_i8']} = {n_quant} a step; the concat "
        f"routes {routes} read through (no torch.cat)")
    del xin
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
    del det, res9, model9

    # int8sb with dynamic scales: one absmax and one K6 launch a conv a step
    det = Detector.load(cfg, device=dev, dtype=torch.bfloat16, precision="default",
                        quant="w8a8")
    kernels.LAUNCHES.update(dict.fromkeys(kernels.LAUNCHES, 0))
    times9d, res9d = pipeline_ms(lambda: det.raw_result(frames, size=SIZE, conf=CONF, iou=IOU,
                                                        max_det=MAX_DET))
    launches9d = dict(kernels.LAUNCHES)
    n9d = len(det.model.qconvs) * (len(times9d) + 3)
    if not (launches9d["absmax"] == launches9d["quantize_i8"] == n9d):
        fail(f"int8sb dynamic: expected {n9d} absmax and K6 launches: {launches9d}")
    check_result(res9d, "int8sb dynamic")
    ms9d = statistics.median(times9d)
    ops9d = device_ops(lambda: det.raw_result(frames, size=SIZE, conf=CONF, iou=IOU,
                                              max_det=MAX_DET))
    with torch.no_grad():
        xin = letterbox_batch(frames, SIZE)
        wide = wide_ops(lambda: det.model(xin, _native_heads=True))
    if wide:
        fail(f"int8sb dynamic forward: float64 or full_like ops on the card: {wide}")
    n_dyn = len(det.model._dynamic)
    say(f"phase 9 yolov3@{SIZE} int8sb with dynamic scales batch {BATCH}: median {ms9d:.3f} "
        f"ms/batch (min {min(times9d):.3f}, max {max(times9d):.3f}); launches {launches9d}; "
        f"device operations a step (torch.profiler: kernels, memsets, copies): static "
        f"{ops9}, dynamic {ops9d} ({n_dyn} dynamic convs: {(ops9d - ops9) / n_dyn:.2f} more "
        f"a dynamic conv than a static step); no float64 or full_like op in the dynamic "
        f"forward (the float64 emulation: ~1,700 a dynamic step, PERF.md §6)")
    del det, res9d, xin

    # K6 alone at the largest int8sb input, (128, 52, 52, 256)
    x6 = torch.randn((BATCH, 52, 52, 256), device=dev,
                     generator=torch.Generator(dev).manual_seed(9))
    s6 = torch.tensor(0.03, device=dev)
    v6 = torch.rand(256, device=dev, generator=torch.Generator(dev).manual_seed(10)) * 0.04 + 0.01

    def library(fn):  # a yardstick only; the port never calls it
        try:
            return time_ms(fn)
        except (RuntimeError, NotImplementedError) as e:
            say(f"phase 9 library call refused: {str(e).splitlines()[0][:160]}")
            return None

    k6 = {}
    for tag, x, sx, lib in (
            ("fp32", x6, s6, lambda: torch.quantize_per_tensor(x6, 0.03, 0, torch.qint8)),
            ("bf16", x6.to(torch.bfloat16), s6, None),
            ("fp32 per channel", x6, v6, lambda: torch.quantize_per_channel(
                x6, v6, torch.zeros(256, dtype=torch.long, device=dev), 3, torch.qint8))):
        if not torch.equal(kernels.quantize_i8(x, sx), kernels.quantize_i8_ref(x, sx)):
            fail(f"K6 {tag} at {tuple(x.shape)}: kernel disagrees with its plain version")
        fn = lambda x=x, sx=sx: kernels.quantize_i8(x, sx)  # noqa: E731
        bms = x.numel() * (x.element_size() + 1) / PEAK_HBM_BYTES * 1e3  # read x, write int8
        lib_ms = library(lib) if lib is not None else None
        if tag == "fp32" and lib_ms is not None:  # K6 and quantize_per_tensor in turns
            dev_ms, lib_dev_ms = in_turns(lib, fn, timer=graph_ms)
        else:
            dev_ms, lib_dev_ms = graph_ms(fn), None
        k6[tag] = dict(ms=time_ms(fn), device_ms=dev_ms, bound_ms=bms, bound_by="bytes",
                       plain_ms=time_ms(lambda x=x, sx=sx: kernels.quantize_i8_ref(x, sx), 5, 1),
                       library_ms=lib_ms, library_device_ms=lib_dev_ms)
        say(f"phase 9 K6 quantize_i8 {tag} {tuple(x.shape)}: {k6[tag]['ms']:.4f} ms eager, "
            f"{dev_ms:.4f} ms device ({bms / dev_ms:.1%} of {bms:.4f} ms, bytes; the first "
            f"K6 {K6_BEFORE[tag]} ms device, PERF.md §6); plain {k6[tag]['plain_ms']:.4f} ms; "
            f"library {lib_ms} ms eager, {lib_dev_ms} ms device in turns with K6; on {card}")
    am = lambda: kernels.absmax(x6, scale=True)  # noqa: E731  the dynamic scale's launch
    if kernels.absmax(x6).item() != kernels.absmax_ref(x6).item():
        fail("K6 absmax at (128, 52, 52, 256): kernel disagrees with its plain version")
    am_bound = x6.numel() * 4 / PEAK_HBM_BYTES * 1e3
    k6["absmax"] = dict(ms=time_ms(am), device_ms=graph_ms(am), bound_ms=am_bound,
                        bound_by="bytes",
                        plain_ms=time_ms(lambda: kernels.absmax_ref(x6, scale=True), 5, 1),
                        library_ms=library(lambda: torch.linalg.vector_norm(x6, float("inf"))))
    say(f"phase 9 K6 absmax + scale fp32 {tuple(x6.shape)}: {k6['absmax']['ms']:.4f} ms eager, "
        f"{k6['absmax']['device_ms']:.4f} ms device ({am_bound / k6['absmax']['device_ms']:.1%} "
        f"of {am_bound:.4f} ms, bytes; the first K6's absmax {K6_BEFORE['absmax']} ms device, "
        f"without the scale); plain {k6['absmax']['plain_ms']:.4f} ms; "
        f"torch.linalg.vector_norm(inf) {k6['absmax']['library_ms']}; on {card}")
    del x6, v6

    # the two route concats of int8sb read through, against torch.cat + K6
    # on the copy at the per-channel scale (the first K6's route), in turns,
    # and against the plain version at this, the main path's, shape
    for tag, side, widths in (("route 86", 26, (256, 512)), ("route 98", 52, (128, 256))):
        xs = [torch.randn((BATCH, side, side, c), device=dev,
                          generator=torch.Generator(dev).manual_seed(c)) for c in widths]
        sxg = [torch.tensor(0.03 + 0.004 * g, device=dev) for g in range(len(xs))]
        sv = torch.cat([s.reshape(1).expand(c) for s, c in zip(sxg, widths)])
        through = lambda xs=xs, sxg=sxg: kernels.quantize_i8(xs, sxg)  # noqa: E731
        copied = lambda xs=xs, sv=sv: kernels.quantize_i8(torch.cat(xs, -1), sv)  # noqa: E731
        got = through()
        if not torch.equal(got, copied()):
            fail(f"K6 {tag}: the read-through differs from K6 on the concatenated copy")
        if not torch.equal(got, kernels.quantize_i8_ref(xs, sxg)):
            fail(f"K6 {tag}: the read-through differs from the plain version")
        del got
        bms = sum(t.numel() for t in xs) * 5 / PEAK_HBM_BYTES * 1e3
        t_through, t_copied = in_turns(copied, through, timer=graph_ms)
        k6[tag] = dict(device_ms=t_through, cat_then_k6_ms=t_copied, bound_ms=bms)
        say(f"phase 9 K6 {tag} {BATCH}x{side}² {'+'.join(map(str, widths))} fp32 read through: "
            f"{t_through:.4f} ms device ({bms / t_through:.1%} of {bms:.4f} ms, bytes) against "
            f"torch.cat + K6 {t_copied:.4f} ms, in turns; on {card}")
        del xs

    # K3 and K4 at batch 128: the wgmma core against the mma.sync core in
    # turns, beside the plain version, cuDNN bf16, torch._int_mm and the bound
    # (and, at every shape and at the 26² conv, the epilogue with a
    # [shortcut] operand: 20 of int8sb's K4 launches a step take one)
    timed = {}
    shapes128 = {**v3_shapes, "3x3 s1 26² 256->512": (3, 1, (8, 26, 26, 256), 512)}
    for name, (k, stride, shape, o) in shapes128.items():
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
        del ref, got
        for sdt in (torch.float32, torch.bfloat16):
            check_shortcut(kernels, errs, "phase 9", f"{name} batch {BATCH}, "
                           f"{str(sdt).removeprefix('torch.')} operand", xq, wq, st, pad, kw, sdt)
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
        del xq, wq, xb, wb
    g9, c9 = timed["1x1 52² 256->128"], timed["3x3 s1 52² 128->256"]
    say(f"phase 9 timings: {json.dumps(timed, ensure_ascii=False)}")

    # 10. live weights: the equalizer on the card, fp32 card vs CPU
    lap("10")
    from pytorch_yolo_tpu_torch.utils.drift import measure_mode_drift
    from pytorch_yolo_tpu_torch.weights import (equalize_raw_params, fold_batchnorm,
                                                random_raw_params)

    t0 = time.perf_counter()
    info = {}
    live_raw = equalize_raw_params(v3, random_raw_params(v3), device=dev, info=info)
    live = fold_batchnorm(v3, live_raw)
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
    lap("11")
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
        before_k5 = {"bf16 s2d": "0.898", "bf16 natural stem": "0.901"}.get(name)
        say(f"phase 11 drift yolov3@{SIZE} live, {name} (stem_s2d={det.stem_s2d}) vs fp32 "
            f"highest: {st.row()}; load+calibrate {load_s:.2f} s; calibration launches "
            f"{ {k: v for k, v in calib_launches.items() if v} }"
            + (f"; set agreement before K5 {before_k5} (the card, cuDNN convs), JAX's CPU row 0.912"
               if before_k5 else ""))
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
    lap("12")
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
    from pytorch_yolo_tpu_torch.models.darknet import _space_to_depth

    with torch.no_grad():  # the convs are K5 modules: conv, bias and leaky in one launch
        xn = xs.permute(0, 3, 1, 2).to(torch.bfloat16)
        y0n = nat0(xn)
        ys = _space_to_depth(xs).permute(0, 3, 1, 2).to(torch.bfloat16)
        y0s = stem_on.stem0(ys)
        y0p = torch.nn.functional.pad(y0s, (1, 0, 1, 0))
        parts = {
            "natural conv0+leaky": lambda: nat0(xn),
            "natural conv1+leaky": lambda: nat1(y0n),
            "s2d permute+cast": lambda: _space_to_depth(xs).permute(0, 3, 1, 2).to(torch.bfloat16),
            "s2d conv0+leaky": lambda: stem_on.stem0(ys),
            "s2d pad": lambda: torch.nn.functional.pad(y0s, (1, 0, 1, 0)),
            "s2d conv1+leaky": lambda: stem_on.stem1(y0p)}
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
    k2l_bound, k2l_by = nms_bound(lvalid, lcls)
    say(f"phase 12 K2 nms_keep {BATCH}x{MAX_DET} on the live step's candidates "
        f"({int(lvalid.sum())} valid, {suppressed} suppressed, fixpoint rounds {live_rounds}): "
        f"{k2l_ms:.4f} ms eager, {k2l_dev_ms:.4f} ms device ({k2l_bound / k2l_dev_ms:.1%} of "
        f"{k2l_bound:.5f} ms, {k2l_by}); phase 6's degenerate candidates {k2_dev_ms:.4f} ms device "
        f"(fixpoint rounds {rounds})")
    say(f"phase 12 timings: {json.dumps(ab)}")
    del det12, heads, rows
    torch.cuda.empty_cache()

    # 13-19. K5 at every conv shape, K2 past K = 1024, the prepared path, the
    # command line, the mesh, yolov4@608 and yolov4-tiny@416; yolov4's live
    # weights (the equalizer on the card) serve phases 13 and 18
    lap("13")
    t0 = time.perf_counter()
    info4: dict = {}
    v4_live = fold_batchnorm(v4, equalize_raw_params(v4, random_raw_params(v4), device=dev,
                                                     info=info4))
    info4["seconds"] = time.perf_counter() - t0
    scaled_live, scaled_info = {}, {}
    for name, _, _ in CSP + LARGE + ZOO_LAST:
        t0 = time.perf_counter()
        scaled_info[name] = {}
        spec = {**csp_specs, **large_specs, **last_specs}[name]
        scaled_live[name] = (spec, fold_batchnorm(spec, equalize_raw_params(
            spec, random_raw_params(spec), device=dev, info=scaled_info[name])))
        scaled_info[name]["seconds"] = time.perf_counter() - t0
    k5 = phase13_k5(kernels, v3, live, frames, dev, card, v4, v4_live)
    torch.cuda.empty_cache()
    k5c = k5_scaled(kernels, frames, dev, card, scaled_live)
    k5["worst"] = {k: (min if k == "equal" else max)(k5["worst"][k], k5c["worst"][k])
                   for k in k5["worst"]}
    k5["cases"] += k5c["cases"]
    lap("14")
    k2_large = phase14_k2_large(kernels, v3, live, frames, dev, rng, card)
    torch.cuda.empty_cache()
    lap("15")
    prepared = phase15_prepared(kernels, v3, live, tiny_spec, tiny_live, calib_live, dev, card)
    torch.cuda.empty_cache()
    lap("16")
    cli16 = phase16_cli(kernels, v3, cfg, live_raw, dev, card, root, ms,
                        rows11["bf16 natural stem"]["agree"])
    torch.cuda.empty_cache()
    lap("17")
    mesh17 = phase17_mesh(kernels, v3, live, tiny_spec, tiny_live, frames, dev, card)
    torch.cuda.empty_cache()
    lap("18")
    v4_18 = phase_model(kernels, 18, V4, V4_SIZE, V4_BATCH, v4, v4_live, info4, frames, calib,
                        dev, card)
    lap("19")
    tiny19 = phase19_yolov4_tiny(kernels, frames, frames4, calib, dev, card)
    scaled_runs = {}
    for phase, (name, size, batch) in zip(range(20, 28), CSP + LARGE + ZOO_LAST):
        lap(str(phase))
        scaled_runs[name] = phase_model(kernels, phase, name, size, batch, *scaled_live[name],
                                        scaled_info[name], frames, calib, dev, card)
        del scaled_live[name]
    k5_main = k5["timed"][f"3x3 s1 {SIZE // 8}² 128->256"]
    stems = {"yolov2": scaled_runs["yolov2"]["int8sb"]["int8_stem"],
             "yolov2-tiny": scaled_runs["yolov2-tiny"]["int8sb"]["int8_stem"],
             "yolov4-tiny": tiny19["int8_stem"]}

    # K5's launches by route in the bf16 steps of the paths that run the
    # "im2col16" route (phases 21b, 24b, 27b)
    launches_by_route = {name: scaled_runs[name]["bf16"]["k5_routes"]
                         for name in ("yolov4x-mish", "yolov4-p7", "yolov2-tiny")}
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
         "library_ms": None, "device_ms": k2_dev_ms, "crowded_device_ms": k2_crowd_dev_ms,
         # the large-K mode: the live step's every candidate, batch 8
         "large_k": k2_large["k"], "large_k_ms": k2_large["ms"],
         "large_k_device_ms": k2_large["device_ms"], "large_k_plain_ms": k2_large["plain_ms"],
         "large_k_bound_ms": k2_large["bound_ms"]},
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
         "device_ms": c9["device_ms"], "v1_ms": c9["old_ms"],
         # the int8 RGB stems alone (phases 19, 26, 27): the mma.sync core
         # they ran on before the packed route, and the packed route
         "rgb_stem_mma": {name: {k: stems[name][k] for k in ("mma_device_ms", "bound_ms")}
                          for name in stems},
         "rgb_stem_packed": {name: {k: stems[name][k] for k in (
             "ms", "device_ms", "bound_ms", "bound_by", "max_abs_err", "plain_ms",
             "cudnn_bf16_device_ms", "k5_bf16_device_ms")} for name in stems}},
        {"name": "int8_conv_packed", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/int8_packed.cu",
         "replaces": "pytorch_yolo_tpu/ops/quant.py:564",
         # the yolov2 int8sb step's launches (phase 26c); its stem's figures
         "launches": scaled_runs["yolov2"]["int8sb"]["launches"]["int8_conv_packed"],
         "max_abs_err": max(errs["int8_conv_packed"], *(v["max_abs_err"] for v in stems.values())),
         "ms": stems["yolov2"]["ms"], "plain_ms": stems["yolov2"]["plain_ms"],
         "bound_ms": stems["yolov2"]["bound_ms"], "bound_by": stems["yolov2"]["bound_by"],
         "library_ms": stems["yolov2"]["cudnn_bf16_device_ms"],
         "device_ms": stems["yolov2"]["device_ms"],
         "v1_ms": stems["yolov2"]["mma_device_ms"],  # the mma.sync core, device time
         "launches_per_path": {"yolov4-tiny": tiny19["int8sb"]["launches"]["int8_conv_packed"],
                               **{name: scaled_runs[name]["int8sb"]["launches"][
                                   "int8_conv_packed"] for name in ("yolov2", "yolov2-tiny")}},
         "stems": stems},
        {"name": "conv_bf16", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/conv_bf16.cu",
         "replaces": "pytorch_yolo_tpu/models/darknet.py:82",
         "launches": launches["conv_bf16"], "max_abs_err": k5["worst"]["abs"],
         "ms": k5_main["ms"], "plain_ms": k5_main["plain_ms"], "bound_ms": k5_main["bound_ms"],
         "bound_by": k5_main["bound_by"], "library_ms": k5_main["library_ms"],
         "device_ms": k5_main["device_ms"],
         "shapes": {k: {kk: v[kk] for kk in ("ms", "device_ms", "library_ms", "bound_ms",
                                             "plan", "launches_per_step")}
                    for k, v in k5["timed"].items()},
         "yolov4_mish_vs_leaky": k5["mish_leaky"],
         # yolov3's C = 32 pair on the "im2col32" route: output digests
         "yolov3_c32_digests": k5["c32_digests"],
         "yolov3_c32_equal_to_parent": k5["c32_equal_to_parent"],
         # the former gather convs (packed, "im2col16" and halo routes now)
         # of yolov4x-mish@640 at batch 64, of yolov4-p7@1536 at batch 8 and
         # of yolov2-tiny@416 at batch 128, beside the gather route and the
         # "im2col16" route for the halo conv in turns; and the "im2col_pad"
         # convs of the first two beside the "im2col32" route in turns (phase 13)
         "gather": {k: {kk: v.get(kk) for kk in (
             "ms", "device_ms", "library_ms", "library_device_ms", "bound_ms", "bound_by",
             "launches_per_step", "plan", "max_abs_err", "device_ms_vs_gather",
             "gather_device_ms", "other_route", "other_route_device_ms")}
                    for k, v in k5c["gather"].items()},
         "im2col_pad": {k: {kk: v.get(kk) for kk in (
             "ms", "device_ms", "library_ms", "library_device_ms", "bound_ms", "bound_by",
             "launches_per_step", "plan", "max_abs_err", "device_ms_vs_im2col32",
             "im2col32_device_ms", "mish_device_ms", "leaky_device_ms")}
                        for k, v in k5c["im2col_pad"].items()},
         "launches_by_route": launches_by_route},
        {"name": "quantize_i8", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/quantize_i8.cu",
         "replaces": "pytorch_yolo_tpu/ops/quant.py:596",
         "launches": launches9["quantize_i8"], "max_abs_err": k6_err,
         "ms": k6["fp32"]["ms"], "plain_ms": k6["fp32"]["plain_ms"],
         "bound_ms": k6["fp32"]["bound_ms"], "bound_by": "bytes",
         "library_ms": k6["fp32"]["library_ms"], "device_ms": k6["fp32"]["device_ms"],
         "bf16": k6["bf16"], "per_channel": k6["fp32 per channel"],
         "route_86": k6["route 86"], "route_98": k6["route 98"]},
        {"name": "absmax", "route": "cuda",
         "source": "pytorch_yolo_tpu_torch/csrc/quantize_i8.cu",
         "replaces": "pytorch_yolo_tpu/ops/quant.py:595",
         "launches": launches9d["absmax"], "max_abs_err": k6_am_err,
         "ms": k6["absmax"]["ms"], "plain_ms": k6["absmax"]["plain_ms"],
         "bound_ms": k6["absmax"]["bound_ms"], "bound_by": "bytes",
         "library_ms": k6["absmax"]["library_ms"], "device_ms": k6["absmax"]["device_ms"]},
    ]}
    say(f"phase 15 timings: {json.dumps(prepared)}")
    say(f"phase 16 timings: {json.dumps(cli16)}")
    say(f"phase 17 timings: {json.dumps(mesh17)}")
    say(f"phase 18 timings: {json.dumps(v4_18)}")
    say(f"phase 19 timings: {json.dumps(tiny19)}")
    for phase, (name, _, _) in zip(range(20, 28), CSP + LARGE + ZOO_LAST):
        say(f"phase {phase} timings: {json.dumps(scaled_runs[name], ensure_ascii=False)}")
    say(f"phase wall seconds: {json.dumps(phase_seconds())}")
    say(json.dumps(report))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""The shape counts: Darknet's own operation counts, from the frozen cfgs."""

import os

from bench_cells import ROOT

from benchmark import roofline
from benchmark.reference.darknet import conv_layers, walk


def _cfg(name):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".cfg"), encoding="utf-8") as f:
        return f.read()


def test_yolov3_416_is_pjreddies_65_86_bn():
    work = roofline.conv_work(_cfg("yolov3-416"), 416, 1, "bf16")
    gflop = roofline.flops(work) / 1e9
    assert len(work) == 75
    assert abs(gflop - 65.86) / 65.86 < 1e-3
    assert round(gflop, 3) == 65.864


def test_yolov4_608_holds_the_release_weights_and_its_bflops():
    """The frozen cfg's convs hold exactly as many numbers as the release's
    yolov4.weights (257,717,640 bytes: a 20-byte header, then fp32 biases,
    batch-norm scales, means and variances, and weights), and count within
    0.1 % of AlexeyAB's published 128.5 BFLOPs at 608 and 60.1 at 416."""
    text = _cfg("yolov4-608")
    _, layers = walk(text, 608)
    numbers = 0
    for conv in conv_layers(layers):
        o, c, k = conv.out_shape[0], conv.in_shape[0], int(conv.opts.get("size", 1))
        numbers += o * c * k * k + (4 * o if int(conv.opts.get("batch_normalize", 0)) else o)
    assert 20 + 4 * numbers == 257_717_640
    work = roofline.conv_work(text, 608, 1, "bf16")
    assert len(work) == 110
    gflop = roofline.flops(work) / 1e9
    assert abs(gflop - 128.5) / 128.5 < 1e-3 and round(gflop, 3) == 128.389
    gflop_416 = roofline.flops(roofline.conv_work(text, 416, 1, "bf16")) / 1e9
    assert abs(gflop_416 - 60.1) / 60.1 < 1e-3


def test_counts_scale_with_batch_and_bound_takes_the_longer():
    text = _cfg("yolov3-416")
    one, many = roofline.conv_work(text, 416, 1, "bf16"), roofline.conv_work(text, 416, 128, "bf16")
    assert roofline.flops(many) == 128 * roofline.flops(one)
    card = "NVIDIA H100 80GB HBM3"
    p = roofline.peaks(card)
    bound = roofline.conv_bound_s(many, card, "bf16")
    assert bound >= roofline.flops(many) / p["ops_per_s"]["bf16"]
    assert bound >= sum(w.bytes for w in many) / p["bytes_per_s"]
    assert roofline.conv_bound_s(many, "cpu", "bf16") is None


def test_shortcut_operand_counted_once_where_fused():
    text = _cfg("yolov3-416")
    work = {w.index: w for w in roofline.conv_work(text, 416, 1, "bf16")}
    # layer 2 (1x1, 64 -> 32) and 3 (3x3 32 -> 64, then [shortcut] at 4)
    plain = 1 * 208 * 208 * 32 * 2 + 64 * 9 * 32 * 2 + 64 * 4 + 208 * 208 * 64 * 2
    assert work[3].bytes == plain + 208 * 208 * 64 * 2

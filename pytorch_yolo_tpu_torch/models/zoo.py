"""Programmatic generators for the YOLO model family, emitting Darknet cfg.

A copy of ``pytorch_yolo_tpu/models/zoo.py`` (the port imports nothing of
the JAX package): the generators, ``available_models``, ``model_spec`` and
``write_cfg``.  The generated text is the JAX package's byte for byte
(``tests/test_torch_serving.py`` holds every generator to its original),
so ``Detector.load("yolov3")`` builds the same model in both packages.
"""

from __future__ import annotations

from ..config import ModelSpec, build_spec, parse_cfg_text

# Anchor tables in net-input pixels (SURVEY.md §5.6 / §3.3, [B]-tier).
YOLOV3_ANCHORS = "10,13, 16,30, 33,23, 30,61, 62,45, 59,119, 116,90, 156,198, 373,326"
YOLOV3_TINY_ANCHORS = "10,14, 23,27, 37,58, 81,82, 135,169, 344,319"
# YOLOv4 (arXiv 2004.10934) anchors; tiny reuses the v3-tiny table with
# masks {3,4,5}/{1,2,3} (upstream yolov4-tiny.cfg leaves anchor 0 unused).
YOLOV4_ANCHORS = "12,16, 19,36, 40,28, 36,75, 76,55, 72,146, 142,110, 192,243, 459,401"
YOLOV4_TINY_ANCHORS = YOLOV3_TINY_ANCHORS
# Scaled-YOLOv4 "large" anchor tables (arXiv 2011.08036 release configs):
# 4 anchors per head.  P6 genuinely repeats anchors across adjacent scales
# (61,45 / 97,189 / 324,451 each serve two heads) — that oddity is upstream.
YOLOV4_P5_ANCHORS = ("13,17, 31,25, 24,51, 61,45, 48,102, 119,96, 97,189, "
                     "217,184, 171,384, 324,451, 616,618, 800,800")
YOLOV4_P6_ANCHORS = ("13,17, 31,25, 24,51, 61,45, 61,45, 48,102, 119,96, "
                     "97,189, 97,189, 217,184, 171,384, 324,451, 324,451, "
                     "545,357, 616,618, 1024,1024")
# P7 re-clusters for 1536x1536 and, like P6, shares anchors across adjacent
# scales (136,138 serves P4+P5; 268,248 serves P5+P6).
YOLOV4_P7_ANCHORS = ("13,17, 22,25, 27,66, 55,41, 57,88, 112,69, 69,177, "
                     "136,138, 136,138, 287,114, 134,275, 268,248, 268,248, "
                     "232,504, 445,416, 640,633, 812,393, 477,808, 1070,908, "
                     "1408,1408")
# YOLOv2 [region] anchors are in grid-cell units (upstream yolov2.cfg, COCO).
YOLOV2_ANCHORS = ("0.57273,0.677385, 1.87446,2.06253, 3.33843,5.47434, "
                  "7.88282,3.52778, 9.77052,9.16828")


def _net(width: int, height: int) -> list[str]:
    return [
        "[net]",
        "batch=1",
        "subdivisions=1",
        f"width={width}",
        f"height={height}",
        "channels=3",
        "",
    ]


def _conv(filters: int, size: int, stride: int = 1, bn: bool = True,
          activation: str = "leaky") -> list[str]:
    lines = ["[convolutional]"]
    if bn:
        lines.append("batch_normalize=1")
    lines += [
        f"filters={filters}",
        f"size={size}",
        f"stride={stride}",
        "pad=1",
        f"activation={activation}",
        "",
    ]
    return lines


def _residual(mid: int, out: int) -> list[str]:
    """Darknet-53 residual unit: 1x1 squeeze -> 3x3 expand -> shortcut(-3)."""
    return (
        _conv(mid, 1)
        + _conv(out, 3)
        + ["[shortcut]", "from=-3", "activation=linear", ""]
    )


def _yolo(mask: str, anchors: str, classes: int, num: int,
          scale_x_y: float | None = None, new_coords: bool = False) -> list[str]:
    lines = [
        "[yolo]",
        f"mask = {mask}",
        f"anchors = {anchors}",
        f"classes={classes}",
        f"num={num}",
        "jitter=.3",
        "ignore_thresh = .7",
        "truth_thresh = 1",
        "random=1",
    ]
    if scale_x_y is not None:
        lines.append(f"scale_x_y = {scale_x_y}")
    if new_coords:
        lines.append("new_coords=1")
    lines.append("")
    return lines


def yolov3_cfg(classes: int = 80, width: int = 416, height: int = 416,
               spp: bool = False) -> str:
    """Full YOLOv3: Darknet-53 backbone + 3-scale FPN head.

    Structure per the YOLOv3 paper Table 1 / upstream cfg (SURVEY.md §3.3):
    stem conv32; five stride-2 stages with 1,2,8,8,4 residual units
    (64,128,256,512,1024 channels); detection head = 5-conv blocks +
    3x3/1x1-linear output at strides 32,16,8 with upsample+route fusion.
    Route targets (61 = end of 512-stage, 36 = end of 256-stage) fall out of
    the generation arithmetic rather than being hand-coded magic numbers.

    ``spp=True`` inserts the spatial-pyramid-pooling block (stride-1
    maxpools k=5/9/13 + 4-way concat) into the first head, matching the
    upstream yolov3-spp variant — exercises only parser features the base
    models already need (stride-1 maxpool, multi-way route).
    """
    filters_out = 3 * (5 + classes)
    lines = _net(width, height)
    layer = -1  # running layer index, mirrors config.build_spec numbering

    def emit(chunk: list[str], n_layers: int) -> None:
        nonlocal layer
        lines.extend(chunk)
        layer += n_layers

    emit(_conv(32, 3), 1)  # stem
    stage_ends: dict[int, int] = {}
    for ch, n_blocks in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        emit(_conv(ch, 3, stride=2), 1)  # downsample
        for _ in range(n_blocks):
            emit(_residual(ch // 2, ch), 3)
        stage_ends[ch] = layer
    assert layer == 74, f"backbone should end at layer 74, got {layer}"
    assert stage_ends[256] == 36 and stage_ends[512] == 61  # upstream indices

    def head(pre_ch: int, mask: str, with_spp: bool = False) -> None:
        # 5-conv block: 1x1 pre, 3x3 2*pre alternating, then 3x3 + 1x1 linear out
        for k in range(3 if with_spp else 5):
            emit(_conv(pre_ch, 1) if k % 2 == 0 else _conv(pre_ch * 2, 3), 1)
        if with_spp:
            # SPP: k5/k9/k13 stride-1 maxpools over the same tensor, 4-way concat
            emit(["[maxpool]", "size=5", "stride=1", ""], 1)
            emit(["[route]", "layers = -2", ""], 1)
            emit(["[maxpool]", "size=9", "stride=1", ""], 1)
            emit(["[route]", "layers = -4", ""], 1)
            emit(["[maxpool]", "size=13", "stride=1", ""], 1)
            emit(["[route]", "layers = -1, -3, -5, -6", ""], 1)
            for k in range(3):
                emit(_conv(pre_ch, 1) if k % 2 == 0 else _conv(pre_ch * 2, 3), 1)
        emit(_conv(pre_ch * 2, 3), 1)
        emit(_conv(filters_out, 1, bn=False, activation="linear"), 1)
        emit(_yolo(mask, YOLOV3_ANCHORS, classes, 9), 1)

    head(512, "6,7,8", with_spp=spp)  # stride 32, 13x13 @416
    emit([f"[route]", f"layers = -4", ""], 1)
    emit(_conv(256, 1), 1)
    emit(["[upsample]", "stride=2", ""], 1)
    emit([f"[route]", f"layers = -1, {stage_ends[512]}", ""], 1)

    head(256, "3,4,5")  # stride 16, 26x26 @416
    emit([f"[route]", f"layers = -4", ""], 1)
    emit(_conv(128, 1), 1)
    emit(["[upsample]", "stride=2", ""], 1)
    emit([f"[route]", f"layers = -1, {stage_ends[256]}", ""], 1)

    head(128, "0,1,2")  # stride 8, 52x52 @416
    expect = 113 if spp else 106  # upstream layer counts
    assert layer == expect, f"should end at layer {expect}, got {layer}"
    return "\n".join(lines)


def yolov3_spp_cfg(classes: int = 80, width: int = 416, height: int = 416) -> str:
    """YOLOv3-SPP: yolov3 with the spatial-pyramid-pooling first head."""
    return yolov3_cfg(classes=classes, width=width, height=height, spp=True)


def yolov3_tiny_cfg(classes: int = 80, width: int = 416, height: int = 416) -> str:
    """Tiny YOLOv3: 7-conv/6-maxpool backbone + 2-scale head.

    Layer layout matches upstream yolov3-tiny.cfg (SURVEY.md §3.3): note the
    size=2,stride=1 maxpool at layer 11 (needs asymmetric pad to keep 13x13)
    and the route to layer 8 (the 256-channel 26x26 feature map).
    """
    filters_out = 3 * (5 + classes)
    lines = _net(width, height)
    # Backbone: conv/maxpool ladder. Layers 0..11.
    for ch in (16, 32, 64, 128, 256, 512):
        lines += _conv(ch, 3)
        stride = 1 if ch == 512 else 2
        lines += ["[maxpool]", "size=2", f"stride={stride}", ""]
    lines += _conv(1024, 3)            # 12
    lines += _conv(256, 1)             # 13
    lines += _conv(512, 3)             # 14
    lines += _conv(filters_out, 1, bn=False, activation="linear")  # 15
    lines += _yolo("3,4,5", YOLOV3_TINY_ANCHORS, classes, 6)       # 16
    lines += ["[route]", "layers = -4", ""]                        # 17 -> 13
    lines += _conv(128, 1)             # 18
    lines += ["[upsample]", "stride=2", ""]                        # 19
    lines += ["[route]", "layers = -1, 8", ""]                     # 20
    lines += _conv(256, 3)             # 21
    lines += _conv(filters_out, 1, bn=False, activation="linear")  # 22
    lines += _yolo("0,1,2", YOLOV3_TINY_ANCHORS, classes, 6)       # 23
    return "\n".join(lines)


def _region(classes: int) -> list[str]:
    return [
        "[region]",
        f"anchors = {YOLOV2_ANCHORS}",
        "bias_match=1",
        f"classes={classes}",
        "coords=4",
        "num=5",
        "softmax=1",
        "jitter=.3",
        "rescore=1",
        "",
    ]


def yolov2_cfg(classes: int = 80, width: int = 416, height: int = 416) -> str:
    """YOLOv2: Darknet-19 backbone + reorg passthrough + [region] head.

    Structure per the YOLO9000 paper (arXiv 1612.08242) / upstream yolov2.cfg:
    conv/maxpool ladder with 1x1 squeezes (Darknet-19), then the passthrough
    branch — route to the 512-ch 26x26 map, 1x1 conv to 64ch, [reorg]
    stride=2 to 256ch 13x13, concat with the 1024-ch trunk — and a single
    13x13 head of 5 anchors (845 detections @416).
    """
    filters_out = 5 * (5 + classes)
    lines = _net(width, height)
    layer = -1

    def emit(chunk: list[str], n_layers: int) -> None:
        nonlocal layer
        lines.extend(chunk)
        layer += n_layers

    emit(_conv(32, 3), 1)                           # 0
    emit(["[maxpool]", "size=2", "stride=2", ""], 1)
    emit(_conv(64, 3), 1)
    emit(["[maxpool]", "size=2", "stride=2", ""], 1)
    for ch in (128, 256):                            # squeeze triples
        emit(_conv(ch, 3), 1)
        emit(_conv(ch // 2, 1), 1)
        emit(_conv(ch, 3), 1)
        emit(["[maxpool]", "size=2", "stride=2", ""], 1)
    for ch, squeezes in ((512, 2), (1024, 2)):       # squeeze quints
        emit(_conv(ch, 3), 1)
        for _ in range(squeezes):
            emit(_conv(ch // 2, 1), 1)
            emit(_conv(ch, 3), 1)
        if ch == 512:
            passthrough_src = layer                  # 512-ch 26x26 map
            emit(["[maxpool]", "size=2", "stride=2", ""], 1)
    assert passthrough_src == 16 and layer == 22     # upstream indices
    emit(_conv(1024, 3), 1)                          # 23
    emit(_conv(1024, 3), 1)                          # 24
    # upstream writes this as the relative "-9"; emit the (equivalent)
    # absolute index the generator already knows
    emit([f"[route]", f"layers = {passthrough_src}", ""], 1)
    emit(_conv(64, 1), 1)
    emit(["[reorg]", "stride=2", ""], 1)             # 64ch 26x26 -> 256ch 13x13
    emit(["[route]", "layers = -1, -4", ""], 1)      # 256 + 1024 = 1280
    emit(_conv(1024, 3), 1)
    emit(_conv(filters_out, 1, bn=False, activation="linear"), 1)
    emit(_region(classes), 1)
    assert layer == 31, f"should end at layer 31, got {layer}"
    return "\n".join(lines)


def yolov2_tiny_cfg(classes: int = 80, width: int = 416, height: int = 416) -> str:
    """Tiny YOLOv2: 6 conv/maxpool pairs (incl. the size=2,stride=1 pool),
    3 trailing convs, single [region] head — upstream yolov2-tiny.cfg."""
    filters_out = 5 * (5 + classes)
    lines = _net(width, height)
    for ch in (16, 32, 64, 128, 256, 512):
        lines += _conv(ch, 3)
        stride = 1 if ch == 512 else 2
        lines += ["[maxpool]", "size=2", f"stride={stride}", ""]
    lines += _conv(1024, 3)
    lines += _conv(512, 3)
    lines += _conv(filters_out, 1, bn=False, activation="linear")
    lines += _region(classes)
    return "\n".join(lines)


def yolov4_cfg(classes: int = 80, width: int = 416, height: int = 416) -> str:
    """YOLOv4: CSPDarknet53 backbone (mish) + SPP + PAN neck (leaky).

    Structure per the YOLOv4 paper (arXiv 2004.10934) / upstream yolov4.cfg.
    Each CSP stage splits the downsampled map into two 1x1 branches, runs
    the residual blocks on one, and concatenates ([route] cross-stage
    partial connections); the neck is yolov3's SPP block plus a PAN
    (top-down upsample fusion at 26²/52², then bottom-up stride-2 re-fusion
    back to 26²/13²).  Heads carry the v4 grid-sensitivity factors
    ``scale_x_y`` = 1.2 / 1.1 / 1.05 at strides 8/16/32.  Generator
    arithmetic reproduces the upstream layer indices (asserted: CSP stage
    ends 54/85, backbone end 104, last layer 161), so upstream
    ``yolov4.weights`` map 1:1 once assets appear."""
    filters_out = 3 * (5 + classes)
    lines = _net(width, height)
    layer = -1

    def emit(chunk: list[str], n_layers: int) -> None:
        nonlocal layer
        lines.extend(chunk)
        layer += n_layers

    def conv(f: int, size: int, stride: int = 1, act: str = "mish",
             bn: bool = True) -> None:
        emit(_conv(f, size, stride=stride, bn=bn, activation=act), 1)

    conv(32, 3)  # stem
    stage_ends: dict[int, int] = {}
    for ch, n_blocks in ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4)):
        conv(ch, 3, stride=2)        # downsample
        half = ch if n_blocks == 1 else ch // 2  # stage-1 branches stay full-width
        conv(half, 1)                # cross-stage (right) branch
        split_idx = layer
        emit(["[route]", "layers = -2", ""], 1)
        conv(half, 1)                # residual trunk (left) entry
        for _ in range(n_blocks):
            conv(ch // 2, 1)
            conv(half, 3)
            emit(["[shortcut]", "from=-3", "activation=linear", ""], 1)
        conv(half, 1)                # close the trunk
        emit([f"[route]", f"layers = -1, {split_idx}", ""], 1)  # CSP concat
        conv(ch, 1)                  # transition
        stage_ends[ch] = layer
    assert stage_ends[256] == 54 and stage_ends[512] == 85, stage_ends
    assert layer == 104, f"backbone should end at layer 104, got {layer}"

    # --- neck: 3 convs + SPP + 3 convs (leaky from here on) ---
    for f, s in ((512, 1), (1024, 3), (512, 1)):
        conv(f, s, act="leaky")
    emit(["[maxpool]", "size=5", "stride=1", ""], 1)
    emit(["[route]", "layers = -2", ""], 1)
    emit(["[maxpool]", "size=9", "stride=1", ""], 1)
    emit(["[route]", "layers = -4", ""], 1)
    emit(["[maxpool]", "size=13", "stride=1", ""], 1)
    emit(["[route]", "layers = -1, -3, -5, -6", ""], 1)
    for f, s in ((512, 1), (1024, 3), (512, 1)):
        conv(f, s, act="leaky")
    neck13 = layer
    assert neck13 == 116

    def five(pre: int) -> None:  # 1x1/3x3 alternating 5-conv block
        for k in range(5):
            conv(pre if k % 2 == 0 else pre * 2, 1 if k % 2 == 0 else 3,
                 act="leaky")

    # --- PAN top-down: 13² -> 26² -> 52² ---
    conv(256, 1, act="leaky")
    emit(["[upsample]", "stride=2", ""], 1)
    emit([f"[route]", f"layers = {stage_ends[512]}", ""], 1)
    conv(256, 1, act="leaky")
    emit(["[route]", "layers = -1, -3", ""], 1)
    five(256)
    neck26 = layer
    assert neck26 == 126
    conv(128, 1, act="leaky")
    emit(["[upsample]", "stride=2", ""], 1)
    emit([f"[route]", f"layers = {stage_ends[256]}", ""], 1)
    conv(128, 1, act="leaky")
    emit(["[route]", "layers = -1, -3", ""], 1)
    five(128)
    neck52 = layer
    assert neck52 == 136

    # --- heads, PAN bottom-up ---
    conv(256, 3, act="leaky")
    conv(filters_out, 1, act="linear", bn=False)
    emit(_yolo("0,1,2", YOLOV4_ANCHORS, classes, 9, scale_x_y=1.2), 1)  # stride 8
    emit([f"[route]", f"layers = {neck52}", ""], 1)
    conv(256, 3, stride=2, act="leaky")
    emit([f"[route]", f"layers = -1, {neck26}", ""], 1)
    five(256)
    conv(512, 3, act="leaky")
    conv(filters_out, 1, act="linear", bn=False)
    emit(_yolo("3,4,5", YOLOV4_ANCHORS, classes, 9, scale_x_y=1.1), 1)  # stride 16
    emit(["[route]", "layers = -4", ""], 1)
    conv(512, 3, stride=2, act="leaky")
    emit([f"[route]", f"layers = -1, {neck13}", ""], 1)
    five(512)
    conv(1024, 3, act="leaky")
    conv(filters_out, 1, act="linear", bn=False)
    emit(_yolo("6,7,8", YOLOV4_ANCHORS, classes, 9, scale_x_y=1.05), 1)  # stride 32
    assert layer == 161, f"should end at layer 161, got {layer}"
    return "\n".join(lines)


def yolov4_tiny_cfg(classes: int = 80, width: int = 416, height: int = 416) -> str:
    """YOLOv4-tiny: CSP split-route backbone + 2-scale head.

    Structure per upstream yolov4-tiny.cfg: a stride-4 stem (two stride-2
    3x3 convs), three CSP blocks — 3x3 conv, split ([route] groups=2
    group_id=1), two 3x3 convs, partial concat, 1x1 transition, full concat,
    2x2 maxpool — then a 13² head and one upsample-fused 26² head, both
    with ``scale_x_y=1.05``.  Masks are upstream's {3,4,5}/{1,2,3} (anchor
    0 unused).  Generator arithmetic reproduces the upstream layer indices
    (asserted: route-26² target 23, last layer 37)."""
    filters_out = 3 * (5 + classes)
    lines = _net(width, height)
    layer = -1

    def emit(chunk: list[str], n_layers: int) -> None:
        nonlocal layer
        lines.extend(chunk)
        layer += n_layers

    emit(_conv(32, 3, stride=2), 1)   # 0
    emit(_conv(64, 3, stride=2), 1)   # 1
    csp_ends = []
    for ch in (64, 128, 256):
        emit(_conv(ch, 3), 1)
        block_in = layer
        emit(["[route]", "layers = -1", "groups=2", "group_id=1", ""], 1)
        emit(_conv(ch // 2, 3), 1)
        emit(_conv(ch // 2, 3), 1)
        emit(["[route]", "layers = -1, -2", ""], 1)
        emit(_conv(ch, 1), 1)
        csp_ends.append(layer)        # 1x1 transition (26² source for ch=256)
        emit([f"[route]", f"layers = {block_in}, -1", ""], 1)
        emit(["[maxpool]", "size=2", "stride=2", ""], 1)
    assert csp_ends[-1] == 23, csp_ends
    emit(_conv(512, 3), 1)            # 26
    emit(_conv(256, 1), 1)            # 27
    emit(_conv(512, 3), 1)            # 28
    emit(_conv(filters_out, 1, bn=False, activation="linear"), 1)
    emit(_yolo("3,4,5", YOLOV4_TINY_ANCHORS, classes, 6, scale_x_y=1.05), 1)  # 30
    emit(["[route]", "layers = -4", ""], 1)
    emit(_conv(128, 1), 1)
    emit(["[upsample]", "stride=2", ""], 1)
    emit([f"[route]", f"layers = -1, {csp_ends[-1]}", ""], 1)
    emit(_conv(256, 3), 1)
    emit(_conv(filters_out, 1, bn=False, activation="linear"), 1)
    emit(_yolo("1,2,3", YOLOV4_TINY_ANCHORS, classes, 6, scale_x_y=1.05), 1)  # 37
    assert layer == 37, f"should end at layer 37, got {layer}"
    return "\n".join(lines)


def _csp_family_cfg(classes: int, width: int, height: int, *,
                    wmul: float = 1.0,
                    blocks: tuple[int, int, int, int] = (2, 8, 8, 4),
                    n2: int = 2,
                    pins: dict[str, int] | None = None) -> str:
    """Shared generator for the Scaled-YOLOv4 CSP family
    (:func:`yolov4_csp_cfg` and its width/depth-scaled
    :func:`yolov4x_mish_cfg` variant) — arXiv 2011.08036.

    [B]-tier structure from the paper: CSPDarknet53 backbone whose FIRST
    stage is reverted to a plain Darknet residual (paper §4.2 — the CSP
    split is not worth it at the narrowest stage); the SPP block and every
    PAN 5-conv block are CSP-ized (split -> ``n2`` 1x1/3x3 bottlenecks ->
    partial concat -> 1x1 transition, the paper's rCSP = the pytorch
    release's ``BottleneckCSP2``); mish activation over the WHOLE body
    (unlike yolov4's leaky neck); the three head convs carry
    ``activation=logistic`` and the ``[yolo]`` blocks set ``scale_x_y=2.0``
    + ``new_coords=1`` (pre-activated decode); anchors/masks are yolov4's.

    ``wmul`` scales every body conv width (rounded to a multiple of 8,
    the release's ``make_divisible``); ``blocks`` lists the residual
    counts of the four CSP stages (base channels 128/256/512/1024);
    ``n2`` is the neck BottleneckCSP2 depth.  ``pins`` optionally asserts
    upstream layer indices at the family's structural landmarks."""
    filters_out = 3 * (5 + classes)

    def w(c: int) -> int:
        return max(8, int(round(c * wmul / 8)) * 8)

    lines = _net(width, height)
    layer = -1

    def emit(chunk: list[str], n_layers: int) -> None:
        nonlocal layer
        lines.extend(chunk)
        layer += n_layers

    def conv(f: int, size: int, stride: int = 1, act: str = "mish",
             bn: bool = True, scaled: bool = True) -> None:
        emit(_conv(w(f) if scaled else f, size, stride=stride, bn=bn,
                   activation=act), 1)

    def pin(name: str) -> None:
        if pins is not None:
            assert layer == pins[name], (name, layer, pins[name])

    conv(32, 3)              # stem
    conv(64, 3, stride=2)    # downsample 1
    conv(32, 1)              # stage 1: plain Darknet residual (paper §4.2)
    conv(64, 3)
    emit(["[shortcut]", "from=-3", "activation=linear", ""], 1)
    assert layer == 4

    stage_ends: dict[int, int] = {}
    for ch, n_blocks in zip((128, 256, 512, 1024), blocks):
        conv(ch, 3, stride=2)        # downsample
        conv(ch // 2, 1)             # cross-stage (right) branch
        split_idx = layer
        emit(["[route]", "layers = -2", ""], 1)
        conv(ch // 2, 1)             # residual trunk (left) entry
        for _ in range(n_blocks):
            conv(ch // 2, 1)
            conv(ch // 2, 3)
            emit(["[shortcut]", "from=-3", "activation=linear", ""], 1)
        conv(ch // 2, 1)             # close the trunk
        emit([f"[route]", f"layers = -1, {split_idx}", ""], 1)  # CSP concat
        conv(ch, 1)                  # transition
        stage_ends[ch] = layer
    if pins is not None:
        assert stage_ends[256] == pins["stage256"], stage_ends
        assert stage_ends[512] == pins["stage512"], stage_ends
    pin("backbone_end")

    def csp2(c: int, fuse_first: bool = True) -> None:
        """CSP-ized 5-conv block (BottleneckCSP2, n=n2): input -> 1x1 c,
        then branch A = 1x1 c, branch B = (1x1 c, 3x3 c) x n2, partial
        concat (2c), 1x1 c transition."""
        if fuse_first:
            conv(c, 1)               # cv1: collapse the 2c concat to c
        conv(c, 1)                   # branch A (off cv1)
        emit(["[route]", "layers = -2", ""], 1)
        for _ in range(n2):          # branch B: shortcut-free bottlenecks
            conv(c, 1)
            conv(c, 3)
        emit([f"[route]", f"layers = -1, {-(2 * n2 + 2)}", ""], 1)  # A ++ B
        conv(c, 1)                   # cv3 transition

    # --- CSP-SPP at stride 32 (all mish) ---
    conv(512, 1)                     # branch A off the backbone end
    emit(["[route]", "layers = -2", ""], 1)
    for f, s in ((512, 1), (512, 3), (512, 1)):
        conv(f, s)                   # branch B pre-SPP stack
    emit(["[maxpool]", "size=5", "stride=1", ""], 1)
    emit(["[route]", "layers = -2", ""], 1)
    emit(["[maxpool]", "size=9", "stride=1", ""], 1)
    emit(["[route]", "layers = -4", ""], 1)
    emit(["[maxpool]", "size=13", "stride=1", ""], 1)
    emit(["[route]", "layers = -1, -3, -5, -6", ""], 1)   # 4x512(*wmul)
    conv(512, 1)
    conv(512, 3)
    emit(["[route]", "layers = -1, -13", ""], 1)          # B ++ A
    conv(512, 1)
    neck13 = layer
    pin("neck13")

    # --- PAN top-down: 13² -> 26² -> 52² ---
    conv(256, 1)
    emit(["[upsample]", "stride=2", ""], 1)
    emit([f"[route]", f"layers = {stage_ends[512]}", ""], 1)
    conv(256, 1)
    emit(["[route]", "layers = -1, -3", ""], 1)           # lateral concat
    csp2(256)
    neck26 = layer
    pin("neck26")
    conv(128, 1)
    emit(["[upsample]", "stride=2", ""], 1)
    emit([f"[route]", f"layers = {stage_ends[256]}", ""], 1)
    conv(128, 1)
    emit(["[route]", "layers = -1, -3", ""], 1)
    csp2(128)
    neck52 = layer
    pin("neck52")

    def head(mask: str) -> None:
        conv(filters_out, 1, act="logistic", bn=False, scaled=False)
        emit(_yolo(mask, YOLOV4_ANCHORS, classes, 9, scale_x_y=2.0,
                   new_coords=True), 1)

    # --- heads + PAN bottom-up (mish body, logistic head convs) ---
    conv(256, 3)
    head("0,1,2")                                          # stride 8
    emit([f"[route]", f"layers = {neck52}", ""], 1)
    conv(256, 3, stride=2)
    emit([f"[route]", f"layers = -1, {neck26}", ""], 1)
    csp2(256)
    pan26 = layer
    conv(512, 3)
    head("3,4,5")                                          # stride 16
    emit([f"[route]", f"layers = {pan26}", ""], 1)
    conv(512, 3, stride=2)
    emit([f"[route]", f"layers = -1, {neck13}", ""], 1)
    csp2(512)
    conv(1024, 3)
    head("6,7,8")                                          # stride 32
    pin("end")
    return "\n".join(lines)


def yolov4_csp_cfg(classes: int = 80, width: int = 512, height: int = 512) -> str:
    """Scaled-YOLOv4 "YOLOv4-CSP" (arXiv 2011.08036): CSP-ized everything.

    Structure and rationale in :func:`_csp_family_cfg` (this is the
    paper's base parameterization: ``BottleneckCSP2(n=2)`` neck, stage
    blocks 2/8/8/4, no width scaling).  Upstream default input is 512x512.

    [C]-PINNED, pending re-verification against a real yolov4-csp.cfg /
    .weights: the exact upstream layer indices and therefore weights-file
    byte compatibility are NOT asserted (unlike :func:`yolov4_cfg`, whose
    indices are pinned to upstream).  Internal arithmetic is asserted
    instead (strides 8/16/32, channel math, CSP concat widths; the
    ``pins`` below are this generator's own landmark ledger)."""
    return _csp_family_cfg(
        classes, width, height, wmul=1.0, blocks=(2, 8, 8, 4), n2=2,
        pins={"stage256": 48, "stage512": 79, "backbone_end": 98,
              "neck13": 113, "neck26": 127, "neck52": 141, "end": 174})


def yolov4x_mish_cfg(classes: int = 80, width: int = 640, height: int = 640) -> str:
    """Scaled-YOLOv4 "YOLOv4x-mish" (the darknet release's CSP-X scaling
    point): :func:`yolov4_csp_cfg` scaled by the family's standard
    width x1.25 / depth x1.33 multipliers — stage blocks
    round(1.33*(2,8,8,4)) = (3,11,11,5), neck ``BottleneckCSP2(n=3)``,
    every body conv width x1.25 (stem 40, stages 160/320/640/1280).
    Upstream default input is 640x640.

    [C]-PINNED like yolov4-csp (upstream layer indices / .weights
    byte-compat unverified against the release yolov4x-mish.cfg); the
    generated topology's own param ledger is asserted in tests."""
    return _csp_family_cfg(classes, width, height,
                           wmul=1.25, blocks=(3, 11, 11, 5), n2=3)


def _yolov4_large_cfg(classes: int, width: int, height: int,
                      stages: tuple[tuple[int, int], ...],
                      anchors: str, anchors_per_head: int,
                      stem_width: int = 32, neck_cap: int = 512) -> str:
    """Shared generator for the Scaled-YOLOv4 "large" models (P5/P6/P7).

    [B]-tier structure from the Scaled-YOLOv4 paper (arXiv 2011.08036,
    §4.3 + the yolov4-large release configs): a fully CSP-ized backbone
    (every stage, including the first, is a standard CSP stage — unlike
    yolov4-csp, which reverts stage 1), a CSP-SPP block on the top
    pyramid level, a PAN neck whose blocks are BottleneckCSP2 with n=3
    (vs n=2 in yolov4-csp), and **4 anchors per head** with
    ``scale_x_y=2.0`` + ``new_coords=1`` pre-activated decode.

    ``stages`` lists (channels, residual_blocks) per pyramid level P1..Ptop;
    heads sit at P3..Ptop (stride 8..2^len(stages)).  Width ladders, all
    arithmetic-derived rather than hand-coded: top-down neck width at
    pyramid level k is ``min(neck_cap, 2^(k+4))`` (128/256/512... capped at
    the CSP-SPP's width ``neck_cap``); head + downsample conv widths equal
    the backbone channels of their level; each bottom-up CSP2 runs at the
    width of the level below.  These ladders reproduce the release configs'
    channel arithmetic for P5 and P6; P7 additionally widens the stem to 40
    and the CSP-SPP/neck cap to 640 (its release applies a 1.25x width
    multiple to the whole trunk).

    [C]-PINNED like :func:`yolov4_csp_cfg`: exact upstream layer indices
    (and therefore .weights byte compatibility) are NOT asserted; internal
    arithmetic (strides, concat widths, anchor count) is asserted instead.
    """
    filters_out = anchors_per_head * (5 + classes)
    n_levels = len(stages)
    head_levels = list(range(2, n_levels))          # stage idx of P3..Ptop
    masks = [",".join(str(anchors_per_head * j + a)
                      for a in range(anchors_per_head))
             for j in range(len(head_levels))]
    num = anchors_per_head * len(head_levels)
    assert num * 2 == len(anchors.split(",")), (num, anchors)

    lines = _net(width, height)
    layer = -1

    def emit(chunk: list[str], n_layers: int) -> None:
        nonlocal layer
        lines.extend(chunk)
        layer += n_layers

    def conv(f: int, size: int, stride: int = 1, act: str = "mish",
             bn: bool = True) -> None:
        emit(_conv(f, size, stride=stride, bn=bn, activation=act), 1)

    conv(stem_width, 3)                             # stem
    stage_ends: list[int] = []                      # transition conv per level
    for ch, n_blocks in stages:
        conv(ch, 3, stride=2)                       # downsample
        conv(ch // 2, 1)                            # cross-stage (right)
        split_idx = layer
        emit(["[route]", "layers = -2", ""], 1)
        conv(ch // 2, 1)                            # trunk entry
        for _ in range(n_blocks):
            conv(ch // 2, 1)
            conv(ch // 2, 3)
            emit(["[shortcut]", "from=-3", "activation=linear", ""], 1)
        conv(ch // 2, 1)                            # close the trunk
        emit([f"[route]", f"layers = -1, {split_idx}", ""], 1)
        conv(ch, 1)                                 # transition
        stage_ends.append(layer)

    def csp2(c: int, n: int = 3, fuse_first: bool = True) -> None:
        """BottleneckCSP2(n): collapse -> branch A 1x1 + branch B n
        shortcut-free bottlenecks -> partial concat -> 1x1 transition."""
        if fuse_first:
            conv(c, 1)
        conv(c, 1)                                  # branch A
        emit(["[route]", "layers = -2", ""], 1)
        for _ in range(n):
            conv(c, 1)
            conv(c, 3)
        emit([f"[route]", f"layers = -1, {-(2 * n + 2)}", ""], 1)
        conv(c, 1)

    # --- CSP-SPP (neck_cap wide) on the top pyramid level ---
    conv(neck_cap, 1)                               # branch A
    emit(["[route]", "layers = -2", ""], 1)
    for f, s in ((neck_cap, 1), (neck_cap, 3), (neck_cap, 1)):
        conv(f, s)                                  # branch B pre-SPP
    emit(["[maxpool]", "size=5", "stride=1", ""], 1)
    emit(["[route]", "layers = -2", ""], 1)
    emit(["[maxpool]", "size=9", "stride=1", ""], 1)
    emit(["[route]", "layers = -4", ""], 1)
    emit(["[maxpool]", "size=13", "stride=1", ""], 1)
    emit(["[route]", "layers = -1, -3, -5, -6", ""], 1)  # 4x neck_cap
    conv(neck_cap, 1)
    conv(neck_cap, 3)
    emit(["[route]", "layers = -1, -13", ""], 1)    # B ++ A = 2x neck_cap
    conv(neck_cap, 1)

    # --- PAN top-down: Ptop-1 ... P3 ---
    neck_out = {head_levels[-1]: layer}             # level idx -> layer idx
    for lvl in range(n_levels - 2, 1, -1):          # P(top-1) down to P3
        w = min(neck_cap, 2 ** (lvl + 5))           # 128/256/512... capped
        conv(w, 1)
        emit(["[upsample]", "stride=2", ""], 1)
        emit([f"[route]", f"layers = {stage_ends[lvl]}", ""], 1)
        conv(w, 1)                                  # lateral
        emit(["[route]", "layers = -1, -3", ""], 1)  # w ++ w
        csp2(w)
        neck_out[lvl] = layer

    # --- heads + PAN bottom-up ---
    def head(mask: str) -> None:
        conv(filters_out, 1, act="logistic", bn=False)
        emit(_yolo(mask, anchors, classes, num, scale_x_y=2.0,
                   new_coords=True), 1)

    bb = [stages[i][0] for i in head_levels]        # backbone ch at P3..Ptop
    conv(bb[0], 3)
    head(masks[0])                                  # stride-8 head
    prev_csp2 = neck_out[2]
    for j in range(1, len(head_levels)):
        emit([f"[route]", f"layers = {prev_csp2}", ""], 1)
        conv(bb[j - 1], 3, stride=2)                # downsample path
        emit([f"[route]", f"layers = -1, {neck_out[head_levels[j]]}", ""], 1)
        csp2(bb[j - 1])
        prev_csp2 = layer
        conv(bb[j], 3)
        head(masks[j])
    return "\n".join(lines)


def yolov4_p5_cfg(classes: int = 80, width: int = 896, height: int = 896) -> str:
    """Scaled-YOLOv4 **P5** (arXiv 2011.08036): CSP stages with 1/3/15/15/7
    residual blocks at 64..1024 channels, 12 anchors over 3 heads
    (strides 8/16/32), upstream default input 896x896.  Release param
    count is 70.8M; this generator's own ledger is asserted in tests."""
    return _yolov4_large_cfg(
        classes, width, height,
        stages=((64, 1), (128, 3), (256, 15), (512, 15), (1024, 7)),
        anchors=YOLOV4_P5_ANCHORS, anchors_per_head=4)


def yolov4_p6_cfg(classes: int = 80, width: int = 1280, height: int = 1280) -> str:
    """Scaled-YOLOv4 **P6**: one more 1024-wide stride-64 stage (P5 level
    narrows to 768), 16 anchors over 4 heads (strides 8/16/32/64),
    upstream default input 1280x1280 — input size must be divisible by
    64.  Release param count is 127.6M."""
    return _yolov4_large_cfg(
        classes, width, height,
        stages=((64, 1), (128, 3), (256, 15), (512, 15), (768, 7), (1024, 7)),
        anchors=YOLOV4_P6_ANCHORS, anchors_per_head=4)


def yolov4_p7_cfg(classes: int = 80, width: int = 1536, height: int = 1536) -> str:
    """Scaled-YOLOv4 **P7**: the deepest published scaling point — a 1.25x
    width multiple over P6's backbone ladder (stem 40, stages 80/160/320/
    640/960 plus two 1280-wide top stages), a stride-128 seventh pyramid
    level, 20 anchors over 5 heads (strides 8/16/32/64/128), CSP-SPP/neck
    cap 640, upstream default input 1536x1536 — input size must be
    divisible by 128.

    [C]-CAVEAT, stronger than P5/P6's: the release's exact neck/head width
    ladder is unverifiable offline and this generator's documented
    arithmetic (``min(neck_cap, 2^(k+4))`` top-down, backbone-width
    bottom-up) yields 338.6M darknet-file floats where the recalled release
    figure is ~287.75M — the release presumably narrows its bottom-up CSP2
    blocks in a way we cannot reconstruct.  Like yolov4x-mish, the test
    ledger pins THIS generator's own topology (structural-drift guard),
    not a public figure; re-derive from the real config if the reference
    mount ever populates (SURVEY.md §7)."""
    return _yolov4_large_cfg(
        classes, width, height,
        stages=((80, 1), (160, 3), (320, 15), (640, 15), (960, 7),
                (1280, 7), (1280, 7)),
        anchors=YOLOV4_P7_ANCHORS, anchors_per_head=4,
        stem_width=40, neck_cap=640)


_GENERATORS = {
    "yolov3": yolov3_cfg,
    "yolov3-spp": yolov3_spp_cfg,
    "yolov3-tiny": yolov3_tiny_cfg,
    "yolov2": yolov2_cfg,
    "yolov2-tiny": yolov2_tiny_cfg,
    "yolov4": yolov4_cfg,
    "yolov4-tiny": yolov4_tiny_cfg,
    "yolov4-csp": yolov4_csp_cfg,
    "yolov4x-mish": yolov4x_mish_cfg,
    "yolov4-p5": yolov4_p5_cfg,
    "yolov4-p6": yolov4_p6_cfg,
    "yolov4-p7": yolov4_p7_cfg,
}


# Per-model topology provenance, surfaced in `info` and the README zoo
# table (VERDICT r3 weak #3: self-pinned topologies shipping under release
# names must be disclosed in the user path, not only in docstrings).
#   "upstream"    — layer indices / param bytes match the public release
#                   exactly (the .weights byte count is the independent
#                   cross-check, assets.EXPECTED_WEIGHTS).
#   "self-pinned" — built from the paper's documented arithmetic; the test
#                   ledger pins THIS generator's topology against drift,
#                   not a verified upstream byte layout ([C], CLAUDE.md).
TOPOLOGY_PINS: "dict[str, tuple[str, str]]" = {
    "yolov3": ("upstream", "param bytes == public release (248,007,048 B)"),
    "yolov3-spp": ("upstream", "param bytes == public release"),
    "yolov3-tiny": ("upstream", "param bytes == public release"),
    "yolov2": ("upstream", "param bytes == public release"),
    "yolov2-tiny": ("upstream", "param bytes == public release"),
    "yolov4": ("upstream", "param bytes == public release (257,717,640 B)"),
    "yolov4-tiny": ("upstream", "param bytes == public release"),
    "yolov4-csp": ("self-pinned",
                   "param count 52,986,205 matches the paper's 52.9M; exact "
                   "upstream layer indices unverified offline"),
    "yolov4x-mish": ("self-pinned",
                     "csp scaled x1.25 width / x1.33 depth per the paper; "
                     "own ledger (97,035,765 params)"),
    "yolov4-p5": ("self-pinned",
                  "ledger 70,917,468 params vs release ~70.8M; layer "
                  "indices unverified offline"),
    "yolov4-p6": ("self-pinned",
                  "ledger 128,529,584 params vs release ~127.6M; layer "
                  "indices unverified offline"),
    "yolov4-p7": ("self-pinned",
                  "DIVERGES from release: our documented width arithmetic "
                  "gives 338,626,204 params where the release is ~287.75M "
                  "— a real yolov4-p7.weights will NOT load; see "
                  "yolov4_p7_cfg docstring"),
}


def available_models() -> tuple[str, ...]:
    return tuple(sorted(_GENERATORS))


def model_spec(name: str, classes: int = 80, width: int | None = None,
               height: int | None = None) -> ModelSpec:
    """Build the named flagship model's :class:`ModelSpec` directly.

    ``width``/``height`` default to each generator's upstream net size
    (416 for the v2/v3/v4 families, 512 for yolov4-csp, 640 for
    yolov4x-mish, 896/1280/1536 for yolov4-p5/p6/p7)."""
    try:
        gen = _GENERATORS[name]
    except KeyError:
        raise ValueError(f"unknown model {name!r}; available: {available_models()}") from None
    kw = {}
    if width is not None:
        kw["width"] = width
    if height is not None:
        kw["height"] = height
    return build_spec(parse_cfg_text(gen(classes=classes, **kw)))


def write_cfg(name: str, path: str, classes: int = 80) -> None:
    """Emit the named model as a standard Darknet .cfg file."""
    gen = _GENERATORS[name]
    with open(path, "w", encoding="utf-8") as f:
        f.write(gen(classes=classes))

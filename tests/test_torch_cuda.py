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
may differ in the last ulps).
"""

import numpy as np
import pytest
import torch

import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch.config import MaxPoolSpec
from pytorch_yolo_tpu_torch.models.darknet import _maxpool
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops.quant import dynamic_scale, quantize_input
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
}


def int8_core_key(name):
    """The LAUNCHES key of the core that ``igemm_plan`` picks for a case."""
    k, stride, shape, o, epi = INT8_CASES[name]
    c = shape[-1]
    splits = epi.get("splits", (c,))
    goff = [0, *np.cumsum(splits).tolist()]
    core, _ = tk.igemm_plan(c, goff, o, "splits" in epi, True)
    base = "int8_gemm" if k == 1 else "int8_conv"
    return base if core == "wgmma" else base + "_mma"


def int8_case(name, device="cpu"):
    """(xq, wq, stride, pad, epilogue kwargs) of an INT8_CASES entry as
    tensors on ``device``; the input scales put the fp32 outputs near unit
    scale, and int8 outputs both round and clip."""
    k, stride, shape, o, epi = INT8_CASES[name]
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
            parts.append(quantize_input(xf[..., off:off + cg], sxg[g]))
            off += cg
        xq, sx_val = torch.cat(parts, -1), 0.03
        kw.update(sxg=sxg, splits=epi["splits"])
    else:
        sx = {"dynamic": lambda: dynamic_scale(xf),
              "static": lambda: t(0.025),
              "vector": lambda: t(rng.uniform(0.01, 0.04, c))}[epi["sx"]]()
        xq = quantize_input(xf, sx)
        sx_val = 1.0 if sx.dim() == 1 else float(sx)
        kw["sx"] = sx
    acc_std = np.sqrt(k * k * c) * 35.0 * 73.0  # |xq| ~ 35, |wq| ~ 73 rms
    kw["ws"] = t(rng.uniform(0.5, 1.5, o) * 1.5 / acc_std / sx_val)
    if "out" in epi:
        kw["out_scale"] = (t(0.012) if epi["out"] == "scalar"
                           else t(rng.uniform(0.008, 0.016, o)))
    return xq, wq, stride, k // 2, kw


def run_int8_case(name, xq, wq, stride, pad, kw, plain=False, mma=False):
    """Run one INT8_CASES entry through K3/K4 (or their plain versions;
    ``mma`` forces the ``mma.sync`` core)."""
    core = {} if plain else {"_mma": mma}
    if INT8_CASES[name][0] == 1:
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
    or a group offset is not a multiple of 16) and forced onto the
    ``mma.sync`` core; the launch goes to the counter of the core that ran."""
    xq, wq, stride, pad, kw = int8_case(name, cuda)
    key = int8_core_key(name)
    if core == "mma":
        key = key.removesuffix("_mma") + "_mma"
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
@pytest.mark.parametrize("size,stride,hw", [(2, 2, 52), (2, 1, 13), (3, 1, 15)])
def test_cuda_int8_maxpool(cuda, size, stride, hw):
    """int8 maxpool on the card equals the fp32 pool of the same values."""
    x = torch.from_numpy(np.random.default_rng(size).integers(-127, 128, (2, 64, hw, hw))
                         .astype(np.int8)).contiguous(memory_format=torch.channels_last)
    spec = MaxPoolSpec(index=0, size=size, stride=stride)
    ours = _maxpool(x.to(cuda), spec)
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.cpu().numpy(),
                                  _maxpool(x.float(), spec).to(torch.int8).numpy())


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
    assert tk.LAUNCHES["int8_conv"] + tk.LAUNCHES["int8_conv_mma"] > (
        before["int8_conv"] + before["int8_conv_mma"])
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

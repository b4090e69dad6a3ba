"""yolov4-p5, yolov4-p6 and yolov4-p7 through the port against the JAX package, on the CPU.

The Scaled-YOLOv4 large family (``models/zoo.py: _yolov4_large_cfg``)
brings what no earlier model ran: four anchors a head (340-channel
logistic head convs), four and five heads in one K1 launch, stride-64 and
stride-128 heads with the early-skip thresholds 16 and 32, int8 convs at
widths 384-1920 (480, 960 and 1600 are not multiples of 128) on split
groups no model sent before (480 + 480, 960 + 640, 768 + 512), and on p7
six convs on K5's "im2col16" and halo routes (C = 40 and 80) and a 3->40
stem on its packed route.  Both sides get the JAX package's
``random_raw_params`` + ``fold_batchnorm`` and the same numpy inputs; the
port's kernels run their plain versions.  Each model's params are built
once for the module (p7's: 338 M fp32 weights, about 1.35 GB a copy), at
the smallest size each allows: p5 and p6 at 64 (p6's stride-64 level is
1x1), p7 at 128.  p7's forwards, int8 heads and detector run these
tests' bodies from ``tests/test_torch_large_p7.py``, a file of their own,
so that the suite's parallel workers (one file a worker) run them beside
p5's and p6's.

Tolerances, each with its reason (those of ``tests/test_torch_csp.py``):
  * the fp32 forwards (He-init): with the head convs made linear, yolov4's
    bound, |ours - JAX| <= 1e-5 max|JAX| + 1e-5 a head (torch's mish
    differs from XLA's in the last ulps and 163-247 convs carry them on);
    the real logistic heads within a quarter of that bound, since the
    sigmoid's slope is at most 1/4, plus 4 fp32 ulps of 1 (torch's
    ``sigmoid`` differs from XLA's by up to 3 ulps);
  * every conv int8, at JAX's static scales (and, on p5, at dynamic ones):
    bit for bit.  On the CPU the plain K3/K4 epilogue computes mish and
    the logistic as XLA:CPU compiles them (``ops/xla_mish.py``, held bit
    for bit by ``tests/test_torch_yolov4.py`` and ``tests/test_torch_csp.py``).
    p5 compares every conv's output through ``collect_conv_out_stats`` on
    both sides (the hook keeps [shortcut]s unfused on both) and the
    unhooked heads; p6 and p7 their heads;
  * p6 at the default skip (threshold 16: the stride-8 and stride-16 convs
    and the heads stay fp32): each conv on JAX's own input to it, the int8
    convs bit for bit and the fp32 ones within 1e-5 of their output's
    scale (+ 1e-5; the logistic heads: of their pre-activation's, carried
    through the sigmoid).  End to end an ulp of an fp32 conv (oneDNN's
    summation order) can cross a rounding boundary of the next int8 conv's
    quantizer, so the heads are not compared end to end;
  * ``Detector`` end to end, fp32: set agreement 1.0 and boxes within half
    a pixel of the 640-pixel frame (a new_coords box side is ``(2 t)^2``
    anchors: an ulp of ``t`` moves it by ~8 anchors x 1.2e-7, times the
    letterbox's 5x from 128 pixels back to 640);
  * letterboxes: atol 1e-5, as ``tests/test_torch_letterbox.py``;
  * K5's plain version against JAX's ``_conv`` in bf16: >= 99.9 % of
    outputs bit-equal and the rest within one bf16 step or the fp32 sum's
    order error, as ``tests/test_torch_conv_bf16.py``;
  * K1's plain version against JAX's Pallas decode in interpret mode: rows
    within 1e-6 (box columns relative to the row's largest corner),
    ``cls_id`` exact, as ``tests/test_torch_kernels.py``.

The module runs the port on one intra-op thread (as the CSP file does:
under the suite's parallel workers a full thread pool per worker
oversubscribes the cores).
"""

import collections
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_yolo_tpu as pj
from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu import weights as jw
from pytorch_yolo_tpu.models import darknet as jdn
from pytorch_yolo_tpu.models import zoo as jzoo
from pytorch_yolo_tpu.ops import pallas_kernels as jpk
from pytorch_yolo_tpu.ops import preprocess as jpre
from pytorch_yolo_tpu.ops import quant as jq
from pytorch_yolo_tpu.ops.decode import head_decode_args as j_head_decode_args
import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch import weights as tw
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.models import zoo as tzoo
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import preprocess as tpre
from pytorch_yolo_tpu_torch.ops import quant as tq
from pytorch_yolo_tpu_torch.ops.decode import head_decode_args
from pytorch_yolo_tpu_torch.utils.drift import detection_drift
from pytorch_yolo_tpu_torch.weights import params_from_jax
from tests.test_torch_conv_bf16 import _jax_conv
from tests.test_torch_cuda import (LARGE_CONV_CASES, assert_rows_close, bf16_agreement,
                                   conv_bf16_floor, conv_bf16_input)
from tests.test_torch_live import _jax_equalize
from tests.torch_threads import one_torch_thread  # noqa: F401

# model -> the smallest input size it allows (a multiple of its deepest stride)
SIZES = {"yolov4-p5": 64, "yolov4-p6": 64, "yolov4-p7": 128}
ULP1 = float(np.spacing(np.float32(1.0)))  # one fp32 ulp of 1, the sigmoid's ceiling


def _specs(text):
    return jcfg.build_spec(jcfg.parse_cfg_text(text)), tcfg.build_spec(tcfg.parse_cfg_text(text))


@pytest.fixture(scope="module")
def model(request):
    """(name, JAX spec, port spec, JAX numpy params, port params, input) of
    the model ``request.param`` at its test size.  Tests take it through
    indirect parametrization, so pytest runs each model's tests together
    and frees its params before it builds the next model's."""
    name = request.param
    jspec, tspec = _specs(jzoo._GENERATORS[name]())
    jp = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=3))
    jp = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jp.items()}
    size = SIZES[name]
    x = np.random.default_rng(3).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    yield name, jspec, tspec, jp, params_from_jax(jp), x
    _SCALES.pop(name, None)
    del jp
    gc.collect()


def _jax_forward(jspec, params, x, quant=None, **kw):
    fwd = jax.jit(jdn.build_forward(jspec, quant=quant, **kw))
    return fwd(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))


def _jax_heads(jspec, params, x, quant=None):
    return [np.asarray(h) for h in _jax_forward(jspec, params, x, quant)]


_SCALES: dict = {}  # model -> JAX's static scales on the module's params and input


def _static_scales(name, jspec, jp, x):
    """JAX's static scales of ``model``, calibrated once while its params
    live (p6's two int8 tests share them)."""
    if name not in _SCALES:
        _SCALES[name] = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x)
    return _SCALES[name]


def _assert_fp32_heads(ours, ref, pre_scale=None):
    """yolov4's bound on linear heads; on logistic heads, a quarter of the
    bound of their pre-activations' scale ``pre_scale`` (one a head), plus
    4 ulps of 1."""
    assert len(ours) == len(ref)
    for j, (o, r) in enumerate(zip(ours, ref)):
        o = o.numpy()
        assert o.dtype == np.float32 and o.shape == r.shape
        if pre_scale is None:
            bound = 1e-5 * np.abs(r).max() + 1e-5
        else:
            bound = 0.25 * (1e-5 * pre_scale[j] + 1e-5) + 4 * ULP1
        assert np.abs(o - r).max() <= bound, (j, np.abs(o - r).max(), bound)


@pytest.mark.parametrize("model", ["yolov4-p5", "yolov4-p6"], indirect=True)
def test_fp32_forward_matches_jax(model):
    """The fp32 forward at the smallest size: with the head convs made
    linear (their pre-activations, the same params) at yolov4's bound, and
    as generated (logistic heads) at that bound carried through the
    sigmoid; 3, 4 or 5 heads of 340 channels."""
    name, jspec, tspec, jp, tp, x = model
    text = jzoo._GENERATORS[name]()
    heads = len(tspec.yolo_layers)
    assert text.count("activation=logistic") == heads == {"yolov4-p5": 3, "yolov4-p6": 4,
                                                          "yolov4-p7": 5}[name]
    jlin, tlin = _specs(text.replace("activation=logistic", "activation=linear"))
    pre = _jax_heads(jlin, jp, x)
    with torch.no_grad():
        ours = tdn.Darknet(tlin, tp)(torch.from_numpy(x))
    _assert_fp32_heads(ours, pre)
    ref = _jax_heads(jspec, jp, x)
    with torch.no_grad():
        ours = tdn.Darknet(tspec, tp)(torch.from_numpy(x))
    shapes = tdn.head_shapes(tspec, x.shape[1], 1)
    assert tuple(tuple(h.shape) for h in ours) == shapes
    assert all(s[-1] == 340 for s in shapes)
    assert shapes[-1][1:3] == ((2, 2) if name == "yolov4-p5" else (1, 1))  # the deepest level
    _assert_fp32_heads(ours, ref, [np.abs(p).max() for p in pre])


@pytest.mark.parametrize("model", ["yolov4-p5"], indirect=True)
@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_p5_every_conv_int8_matches_jax_bit_for_bit(model, scales):
    """yolov4-p5 w8a8 with no conv skipped (163 int8 convs, the three
    340-channel logistic heads among them), at JAX's static scales
    (int8-resident chains) or dynamic ones: every conv's output and the
    heads equal JAX's bit for bit."""
    name, jspec, tspec, jp, tp, x = model
    act = _static_scales(name, jspec, jp, x) if scales == "static" else None
    qp = jq.quantize_params(jspec, jp, (), act)
    jheads, jouts = _jax_forward(jspec, qp, x, "w8a8", collect_conv_out_stats=lambda i, t: t)
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, (), act), quant="w8a8")
    assert not net.convs and len(net.qconvs) == 163
    assert bool(net._chains) == (scales == "static")
    with torch.no_grad():
        heads, outs = net(torch.from_numpy(x), collect_conv_out_stats=lambda i, t: t.clone())
        plain = net(torch.from_numpy(x))
    assert sorted(outs) == sorted(jouts) and len(outs) == 163
    for i in sorted(outs):
        np.testing.assert_array_equal(outs[i].numpy(), np.asarray(jouts[i]), err_msg=f"conv {i}")
    for o, r in zip(heads, jheads):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for o, r in zip(plain, _jax_heads(jspec, qp, x, "w8a8")):
        np.testing.assert_array_equal(o.numpy(), r)


@pytest.mark.parametrize("model", ["yolov4-p6"], indirect=True)
def test_every_conv_int8_heads_match_jax_bit_for_bit(model):
    """p6 and p7 w8a8 with no conv skipped, at JAX's static scales: the
    heads equal JAX's bit for bit.  This runs the plain K3/K4 epilogue at
    p7's new input widths (480, 960, 1152, 1600, 1920) and split groups
    (480 + 480, 960 + 640, 1280 + 640, 960 + 960), and p6's (384, 768,
    1536; 768 + 512, 384 + 384)."""
    name, jspec, tspec, jp, tp, x = model
    act = _static_scales(name, jspec, jp, x)
    qp = jq.quantize_params(jspec, jp, (), act)
    ref = _jax_heads(jspec, qp, x, "w8a8")
    del qp
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, (), act), quant="w8a8")
    convs = [l for l in tspec.layers if isinstance(l, tcfg.ConvSpec)]
    assert not net.convs and len(net.qconvs) == len(convs) and net._chains
    widths = {l.in_channels for l in convs}
    splits = set(tq.concat_split_groups(tspec).values())
    if name == "yolov4-p7":
        assert {480, 960, 1152, 1600, 1920} <= widths
        assert {(480, 480), (960, 640), (1280, 640), (960, 960)} <= splits
    else:
        assert {384, 768, 1536} <= widths and {(768, 512), (384, 384)} <= splits
    with torch.no_grad():
        heads = net(torch.from_numpy(x))
    for o, r in zip(heads, ref):
        np.testing.assert_array_equal(o.numpy(), r)


@pytest.mark.parametrize("model", ["yolov4-p6"], indirect=True)
def test_p6_default_skip_int8_matches_jax(model):
    """yolov4-p6 w8a8 at the default skip for its topology: early-skip
    threshold 16 (the deepest head stride is 64), so every conv at input
    stride below 16 and the four heads stay fp32, 71 convs, and 134 are
    int8.  Each conv runs on JAX's own input to it (taken by the stats
    hook): the int8 convs give JAX's output bit for bit, the fp32 ones
    within 1e-5 of its scale (+ 1e-5)."""
    name, jspec, tspec, jp, tp, x = model
    act = _static_scales(name, jspec, jp, x)
    early = tq.default_early_min_stride(tspec)
    skip = jq.resolve_skip_layers(jspec, "heads", default_min_stride=early)
    assert early == jq.default_early_min_stride(jspec) == 16 and len(skip) == 71
    assert skip == tq.resolve_skip_layers(tspec, "heads", default_min_stride=early)
    qp = jq.quantize_params(jspec, jp, skip, act)
    _, ins = _jax_forward(jspec, qp, x, "w8a8", collect_conv_in_stats=lambda i, t: t)
    _, outs = _jax_forward(jspec, qp, x, "w8a8", collect_conv_out_stats=lambda i, t: t)
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, skip, act), quant="w8a8")
    assert len(net.qconvs) == 134 and len(net.convs) == 71 and net._chains
    with torch.no_grad():
        for layer in tspec.layers:
            if not isinstance(layer, tcfg.ConvSpec):
                continue
            i = layer.index
            xin = torch.from_numpy(np.asarray(ins[i])).permute(0, 3, 1, 2)
            ref = np.asarray(outs[i])
            if i in skip:
                conv = net._conv_at[i]
                ours = net._run_conv(conv, xin).permute(0, 2, 3, 1).numpy()
                bound = 1e-5 * np.abs(ref).max() + 1e-5
                if layer.activation == "logistic":  # the bound of the pre-activation, / 4
                    pre = float(conv(xin).abs().max())
                    bound = 0.25 * (1e-5 * pre + 1e-5) + 4 * ULP1
                assert np.abs(ours - ref).max() <= bound, (i, np.abs(ours - ref).max(), bound)
            else:
                ours = net._quantized(xin, layer).permute(0, 2, 3, 1).numpy()
                assert ours.dtype == ref.dtype
                np.testing.assert_array_equal(ours, ref, err_msg=f"conv {i}")


@pytest.mark.parametrize("model", ["yolov4-p6"], indirect=True)
def test_detector_matches_jax(model):
    """``Detector`` end to end, fp32, at 128: the port's CPU detector
    against the JAX ``Detector`` with its Pallas kernels (interpret mode),
    both on the module's params, on two 480x640 frames: set agreement 1.0.
    Four or five new_coords heads of four anchors go through K1 in one
    call and K2 on their candidates."""
    _, jspec, tspec, jp, tp, _ = model
    frames = np.random.default_rng(0).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    ref = pj.Detector(jspec, jp, use_pallas=True).detect_batch(frames, size=128, conf=0.5,
                                                               iou=0.4)
    ours = pt.Detector(tspec, tp, device="cpu").detect_batch(frames, size=128, conf=0.5,
                                                             iou=0.4)
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    for a, b in zip(ref, ours):
        np.testing.assert_array_equal(b.cls_id, a.cls_id)
        assert np.abs(b.boxes - a.boxes).max() <= 0.5


@pytest.mark.parametrize("name", ["yolov4-p6", "yolov4-p7"])
def test_decode_four_anchor_heads_match_pallas(name):
    """K1's plain version on the model's four or five new_coords heads of
    four anchors (340 channels, scale_x_y 2.0, values a logistic conv
    already squashed) at 512, about 21,800 rows a frame, against JAX's
    Pallas decode in interpret mode, and in one call over every head
    (``decode_score_all``)."""
    size = 512
    spec = tzoo.model_spec(name)
    jspec = jzoo.model_spec(name)
    strides = tcfg.head_strides(spec)
    assert strides == jcfg.head_strides(jspec) == (8, 16, 32, 64, 128)[:len(strides)]
    rng = np.random.default_rng(size + len(strides))
    raws, refs = [], []
    for h, jh, s in zip(spec.yolo_layers, jspec.yolo_layers, strides):
        anchors, cls_act, sxy, nc = head_decode_args(h, s)
        assert (anchors, cls_act, sxy, nc) == j_head_decode_args(jh, s)
        assert (len(anchors), cls_act, sxy, nc) == (4, "linear", 2.0, True)
        raw = rng.uniform(0, 1, (1, size // s, size // s, 340)).astype(np.float32)
        ref = np.asarray(jpk.decode_score_head(jnp.asarray(raw), anchors, s, h.classes,
                                               cls_act=cls_act, scale_xy=sxy, new_coords=nc,
                                               interpret=True))
        ours = tk.decode_score_head(torch.from_numpy(raw), anchors, s, h.classes,
                                    cls_act=cls_act, scale_xy=sxy, new_coords=nc)
        assert_rows_close(ours.numpy(), ref)
        raws.append(torch.from_numpy(raw))
        refs.append(ref)
    rows = tk.decode_score_all(tuple(raws), spec)
    assert rows.shape[1] == 4 * sum((size // s) ** 2 for s in strides) > 21_700
    assert_rows_close(rows.numpy(), np.concatenate(refs, 1))


def test_equalize_matches_jax_on_p6():
    """``equalize_raw_params`` on a model with a stride-64 head: the port's
    sweeps and rescaled kernels against JAX's at a 64-pixel probe (the
    smallest multiple of its deepest stride)."""
    jspec, tspec = _specs(jzoo._GENERATORS["yolov4-p6"]())
    ref, forwards = _jax_equalize(jspec, jw.random_raw_params(jspec), size=64)
    info = {}
    ours = tw.equalize_raw_params(tspec, tw.random_raw_params(tspec), size=64, device="cpu",
                                  info=info)
    assert info["converged"] and info["sweeps"] + 1 == forwards and info["unscaled"] == []
    for i, r in ref.items():
        np.testing.assert_allclose(ours[i]["w"], r["w"].transpose(3, 2, 0, 1), rtol=1e-4)


@pytest.mark.parametrize("size", [896, 1280, 1536])
def test_letterbox_matches_jax(size):
    """480x640 frames into p5's 896, p6's 1280 and p7's 1536 (scaled up by
    1.4, 2.0 and 2.4)."""
    imgs = np.random.default_rng(size).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    geo = tpre.letterbox_geometry(480, 640, size)
    assert geo == jpre.letterbox_geometry(480, 640, size)
    assert geo.scale == size / 640
    ref = np.asarray(jpre.letterbox_batch(jnp.asarray(imgs), size=size))
    ours = tpre.letterbox_batch(torch.from_numpy(imgs), size)
    assert tuple(ours.shape) == (2, size, size, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(LARGE_CONV_CASES))
def test_conv_bf16_plain_matches_jax_conv(name):
    """K5's plain version against JAX's ``_conv`` in bf16 at p7's new
    shapes (the 3x3 s1 40->40 halo-route conv, a C = 480 conv on the
    "im2col_pad" route, the 340-output logistic head convs), each at a reduced spatial
    size (24², or 48² before a stride-2 conv)."""
    route, (n, h, w, *rest) = LARGE_CONV_CASES[name]
    side = 48 if rest[3] == 2 else 24
    x, w_, b, stride, pad, act, sc = conv_bf16_input(name, case=(n, side, side, *rest))
    assert tk.conv_bf16_plan(x.shape[-1], w_.shape[0], w_.shape[1], w_.shape[2], stride,
                             pad)[0] == route
    ours = tk.conv_bf16(x, w_, b, stride, pad, act, sc)
    ref = _jax_conv(x.float().numpy(), w_.float().numpy(), b.numpy(), stride, pad, act,
                    None if sc is None else sc.float().numpy())
    assert tuple(ours.shape) == ref.shape
    equal, ulps = bf16_agreement(ours, torch.from_numpy(ref.copy()),
                                 conv_bf16_floor(x, w_, b, stride, pad, sc))
    assert equal >= 0.999 and ulps <= 1, (name, equal, ulps)


# name -> K5 routes of the bf16 model, int8sb (default skip): K3, K4, K5
# convs, the convs after a concat (split groups), the early-skip threshold
PLANS = {
    "yolov4-p5": ({"tma": 97, "im2col": 63, "im2col32": 2, "packed": 1}, (82, 58, 23, 13), 8),
    "yolov4-p6": ({"tma": 123, "im2col": 79, "im2col32": 2, "packed": 1}, (81, 53, 71, 15), 16),
    "yolov4-p7": ({"tma": 149, "im2col": 68, "im2col_pad": 23, "packed": 1, "im2col16": 5,
                   "halo": 1}, (73, 45, 129, 15), 32),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_family_plans(name):
    """What each model sends to each kernel: the generator's text equal to
    the JAX package's, K5's route for every conv of the bf16 model (p7's
    six C % 32 != 0 convs: layers 1, 11, 16, 19, 22 on 16-channel boxes,
    the 40 -> 40 layer 6 on the halo route; its 3->40 stem on the packed
    route), and int8sb's
    convs at the default skip, whose set and early threshold equal the JAX
    package's: 1x1 stride-1 on K3, the rest on K4, none on the
    ``mma.sync`` core; the split-concat convs among them; the SPP block's
    three pools and its four-source route."""
    routes, (k3n, k4n, k5n, nsplit), early = PLANS[name]
    assert tzoo._GENERATORS[name]() == jzoo._GENERATORS[name]()
    spec, jspec = tzoo.model_spec(name), jzoo.model_spec(name)
    convs = [l for l in spec.layers if isinstance(l, tcfg.ConvSpec)]
    plans = {l.index: tk.conv_bf16_plan(l.in_channels, l.filters, l.size, l.size, l.stride,
                                        l.padding) for l in convs}
    assert dict(collections.Counter(p[0] for p in plans.values())) == routes
    boxed = sorted(i for i, p in plans.items() if p[0] in ("im2col16", "halo"))
    assert boxed == ([1, 6, 11, 16, 19, 22] if "im2col16" in routes else [])
    assert [i for i, p in plans.items() if p[0] == "halo"] == ([6] if "halo" in routes else [])
    assert tq.default_early_min_stride(spec) == jq.default_early_min_stride(jspec) == early
    skip = tq.resolve_skip_layers(spec, "heads", default_min_stride=early)
    assert skip == jq.resolve_skip_layers(jspec, "heads", default_min_stride=early)
    q = [l for l in convs if l.index not in skip]
    k3 = [l for l in q if l.size == 1 and l.stride == 1]
    assert (len(k3), len(q) - len(k3), len(convs) - len(q)) == (k3n, k4n, k5n)
    assert all(tk.igemm_plan(l.in_channels, [0, l.in_channels], l.filters, False, True,
                             l.size, l.size, l.stride, l.padding)[0] == "wgmma" for l in q)
    split = tq.concat_split_groups(spec)
    assert split == jq.concat_split_groups(jspec)
    assert sum(1 for l in q if l.index in split) == nsplit
    pools = [l.index for l in spec.layers if isinstance(l, tcfg.MaxPoolSpec)]
    spp = [l.index for l in spec.layers if isinstance(l, tcfg.RouteSpec) and len(l.layers) == 4]
    assert spp == [pools[-1] + 1] and pools == [spp[0] - 5, spp[0] - 3, spp[0] - 1]
    assert spp[0] == {"yolov4-p5": 169, "yolov4-p6": 197, "yolov4-p7": 225}[name]

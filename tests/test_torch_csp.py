"""yolov4-csp and yolov4x-mish through the port against the JAX package, on the CPU.

The Scaled-YOLOv4 CSP family (``models/zoo.py: _csp_family_cfg``) brings
what no earlier model ran: mish over the whole body, CSP splits and
concats everywhere (the CSP-SPP block's routes ``-1,-3,-5,-6`` and
``-1,-13``), bias-only ``activation=logistic`` head convs, ``[yolo]
new_coords=1, scale_x_y=2.0`` heads decoded without K1's own sigmoid, and
in yolov4x-mish convs of 40 and 80 channels that K5 sends down its
"im2col16" route (16-channel boxes).  Both sides get the JAX package's ``random_raw_params`` +
``fold_batchnorm`` and the same numpy inputs; the port's kernels run their
plain versions.

Tolerances, each with its reason:
  * the fp32 forward at 64 pixels (He-init: the head convs' pre-activations
    reach ~10^2-10^3): with the head convs made linear, yolov4's bound,
    |ours - JAX| <= 1e-5 max|JAX| + 1e-5 a head (torch's mish differs from
    XLA's in the last ulps and 115 / 139 layers carry them on); the real
    logistic heads within a quarter of that bound, since the sigmoid's
    slope is at most 1/4, plus 4 fp32 ulps of 1 (torch's ``sigmoid``
    differs from XLA's by up to 3 ulps);
  * yolov4-csp with every conv int8, at JAX's static scales and at dynamic
    ones: bit for bit, every conv's output and the heads.  The logistic
    head convs are not held to a tolerance: on the CPU the plain K3/K4
    epilogue computes the sigmoid as XLA:CPU compiles ``jax.nn.sigmoid``
    (``1 / (exp(-y) + 1)`` on XLA's inlined ``exp``, the product fused into
    the add, subnormals flushed: ``ops/xla_mish.py: logistic``), which
    ``test_xla_logistic_matches_jax`` holds bit for bit on 2^23 inputs
    (torch's ``sigmoid`` misses XLA's on 0.5 % of them, and keeps the
    subnormal outputs XLA flushes).  Each conv's output is taken through
    the stats hook ``collect_conv_out_stats`` on both sides, in one
    forward each (JAX's ``stop_at`` would compile one truncated program a
    conv); the hook keeps every [shortcut] unfused on both sides, and the
    unhooked heads are compared as well;
  * the default skip (the stride-8 early skip and the heads: 17 fp32 convs
    of yolov4-csp, 14 mish and 3 logistic): each conv on JAX's own input to
    it, the 98 int8 convs bit for bit and the fp32 ones within 1e-5 of
    their output's scale (+ 1e-5; the logistic heads: of their
    pre-activation's, carried through the sigmoid as above).  The heads end to end are not held to
    the fp32 bound: an fp32 conv sums in oneDNN's order, not XLA's, and
    where its ulps cross a rounding boundary of the next int8 conv's
    quantizer an int8 value moves by a step, which the 98 int8 layers carry
    on (at 64 pixels a head logit moved by ~4, a sigmoid from 1e-13 to 1);
  * ``Detector`` end to end, fp32: set agreement 1.0, as
    ``tests/test_torch_yolov4.py``, and boxes within half a pixel of the
    640-pixel frame (measured 0.023-0.071 px from run to run: oneDNN's
    sums change their order with its threads).  yolov4's raw heads are
    held to 1e-2 px; here a new_coords box side is ``(2 t)^2`` anchors, so
    an ulp of a head value ``t`` near 1 moves it by ~8 anchors x 1.2e-7,
    times the letterbox's 10x from 64 pixels back to 640;
  * letterboxes: atol 1e-5, as ``tests/test_torch_letterbox.py``;
  * K5's plain version against JAX's ``_conv`` in bf16: >= 99.9 % of
    outputs bit-equal and the rest within one bf16 step or the fp32 sum's
    order error, as ``tests/test_torch_conv_bf16.py``;
  * K1's plain version against JAX's Pallas decode in interpret mode: rows
    within 1e-6 (box columns relative to the row's largest corner),
    ``cls_id`` exact, as ``tests/test_torch_kernels.py``.
"""

import collections

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pytorch_yolo_tpu as pj
from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu import weights as jw
from pytorch_yolo_tpu.models import darknet as jdn
from pytorch_yolo_tpu.models.zoo import _GENERATORS
from pytorch_yolo_tpu.ops import pallas_kernels as jpk
from pytorch_yolo_tpu.ops import preprocess as jpre
from pytorch_yolo_tpu.ops import quant as jq
from pytorch_yolo_tpu.ops.decode import head_decode_args as j_head_decode_args
import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.models.zoo import model_spec
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import preprocess as tpre
from pytorch_yolo_tpu_torch.ops import quant as tq
from pytorch_yolo_tpu_torch.ops.decode import head_decode_args
from pytorch_yolo_tpu_torch.ops.xla_mish import logistic
from pytorch_yolo_tpu_torch.utils.drift import detection_drift
from pytorch_yolo_tpu_torch.weights import params_from_jax
from tests.test_torch_conv_bf16 import _jax_conv
from tests.test_torch_cuda import (CSP_CONV_CASES, assert_rows_close, bf16_agreement,
                                   conv_bf16_floor, conv_bf16_input)
from tests.test_torch_quantize_i8 import _float_cats
from tests.torch_threads import one_torch_thread  # noqa: F401

MODELS = ("yolov4-csp", "yolov4x-mish")
SIZE, BATCH = 64, 1
ULP1 = float(np.spacing(np.float32(1.0)))  # one fp32 ulp of 1, the sigmoid's ceiling


def _case(name):
    """Both packages' specs, numpy params and input of ``name`` at 64
    pixels."""
    return _build(_GENERATORS[name]())


def _build(text, seed=3):
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    jp = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=seed))
    jp = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jp.items()}
    x = np.random.default_rng(seed).uniform(0, 1, (BATCH, SIZE, SIZE, 3)).astype(np.float32)
    return jspec, tspec, jp, x


@pytest.fixture(scope="module")
def csp():
    """(JAX spec, port spec, JAX numpy params, port params, input, JAX
    static scales) of yolov4-csp at 64 pixels."""
    jspec, tspec, jp, x = _case("yolov4-csp")
    act = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x)
    return jspec, tspec, jp, params_from_jax(jp), x, act


def _jax_forward(jspec, params, x, quant=None, **kw):
    fwd = jax.jit(jdn.build_forward(jspec, quant=quant, **kw))
    return fwd(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))


def _jax_heads(jspec, params, x, quant=None):
    return [np.asarray(h) for h in _jax_forward(jspec, params, x, quant)]


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


def test_xla_logistic_matches_jax():
    """The CPU epilogue's logistic against XLA's compiled ``jax.nn.sigmoid``
    on 2^23 values over six scales (and zeros, subnormals, the exp clamp's
    edges): bit for bit; torch's ``sigmoid`` differs on some of them."""
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.normal(0, s, 1 << 20) for s in (0.01, 0.3, 1, 3, 10, 100)]
                       + [rng.uniform(-120, 120, 1 << 21)]).astype(np.float32)
    y[:12] = [0.0, -0.0, 1e-30, -1e-30, 88.0, -88.0, 200.0, -200.0, 1e-40, -1e-40, 87.5, -103.0]
    ref = np.asarray(jax.jit(lambda v: jdn.apply_activation(v, "logistic"))(jnp.asarray(y)))
    ours = logistic(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    torch_sig = tdn.apply_activation(torch.from_numpy(y), "logistic").numpy()
    assert 0 < (torch_sig != ref).mean() < 0.02


@pytest.mark.parametrize("name", MODELS)
def test_fp32_forward_matches_jax(name):
    """The fp32 forward: with the head convs made linear (their
    pre-activations) at yolov4's bound, and as generated (logistic heads)
    at that bound carried through the sigmoid."""
    text = _GENERATORS[name]()
    assert text.count("activation=logistic") == 3
    lin = _build(text.replace("activation=logistic", "activation=linear"))
    jspec, tspec, jp, x = lin
    pre = _jax_heads(jspec, jp, x)
    ours = tdn.Darknet(tspec, params_from_jax(jp))(torch.from_numpy(x))
    _assert_fp32_heads(ours, pre)
    jspec, tspec, jp, x = _case(name)
    ref = _jax_heads(jspec, jp, x)
    ours = tdn.Darknet(tspec, params_from_jax(jp))(torch.from_numpy(x))
    assert tuple(tuple(h.shape) for h in ours) == tdn.head_shapes(tspec, SIZE, BATCH)
    _assert_fp32_heads(ours, ref, [np.abs(p).max() for p in pre])


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_every_conv_int8_matches_jax_bit_for_bit(csp, scales):
    """w8a8 with no conv skipped (115 int8 convs, the three logistic heads
    among them), JAX's static scales (int8-resident chains) or dynamic
    ones: every conv's output and the heads equal JAX's bit for bit."""
    jspec, tspec, jp, tp, x, act = csp
    act = act if scales == "static" else None
    qp = jq.quantize_params(jspec, jp, (), act)
    jheads, jouts = _jax_forward(jspec, qp, x, "w8a8",
                                 collect_conv_out_stats=lambda i, t: t)
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, (), act), quant="w8a8")
    assert not net.convs and len(net.qconvs) == 115
    assert bool(net._chains) == (scales == "static")
    heads, outs = net(torch.from_numpy(x), collect_conv_out_stats=lambda i, t: t.clone())
    assert sorted(outs) == sorted(jouts) and len(outs) == 115
    for i in sorted(outs):
        np.testing.assert_array_equal(outs[i].numpy(), np.asarray(jouts[i]), err_msg=f"conv {i}")
    for o, r in zip(heads, jheads):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for o, r in zip(net(torch.from_numpy(x)), _jax_heads(jspec, qp, x, "w8a8")):
        np.testing.assert_array_equal(o.numpy(), r)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_default_skip_int8_matches_jax(csp, scales):
    """w8a8 with the default skip for the topology: the stride-8 early
    skip and the heads, 17 fp32 convs (14 mish, 3 logistic); 98 int8.
    Each conv runs on JAX's own input to it (taken by the stats hook): the
    int8 convs give JAX's output bit for bit, the fp32 ones within 1e-5 of
    its scale (+ 1e-5)."""
    jspec, tspec, jp, tp, x, act = csp
    act = act if scales == "static" else None
    early = tq.default_early_min_stride(tspec)
    skip = jq.resolve_skip_layers(jspec, "heads", default_min_stride=early)
    assert early == 8 and len(skip) == 17
    assert skip == tq.resolve_skip_layers(tspec, "heads", default_min_stride=early)
    qp = jq.quantize_params(jspec, jp, skip, act)
    _, ins = _jax_forward(jspec, qp, x, "w8a8", collect_conv_in_stats=lambda i, t: t)
    _, outs = _jax_forward(jspec, qp, x, "w8a8", collect_conv_out_stats=lambda i, t: t)
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, skip, act), quant="w8a8")
    assert len(net.qconvs) == 98 and len(net.convs) == 17
    assert bool(net._chains) == (scales == "static")
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


def test_csp_spp_route_read_through_matches_jax(csp, monkeypatch):
    """yolov4-csp's int8 forward at JAX's static scales with every conv
    int8: each of the 14 multi-source routes, the CSP-SPP route 109 (four
    512-channel sources) and the CSP concat 112 (``-1,-13``) included, is
    read through by the next conv's K6 with no ``torch.cat`` of its
    sources, and the heads are JAX's bits; a layer hook brings the copies
    back and the same heads."""
    jspec, tspec, jp, tp, x, act = csp
    ref = _jax_heads(jspec, jq.quantize_params(jspec, jp, (), act), x, quant="w8a8")
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, (), act), quant="w8a8")
    routes = {l.index for l in tspec.layers if isinstance(l, tcfg.RouteSpec) and len(l.layers) > 1}
    assert net._read_through == routes and len(routes) == 14
    assert tspec.layers[109].layers == (108, 106, 104, 103)
    assert tspec.layers[112].layers == (111, 99)
    cats = _float_cats(monkeypatch)
    heads = net(torch.from_numpy(x))
    assert cats == []
    for o, r in zip(heads, ref):
        np.testing.assert_array_equal(o.numpy(), r)
    net.layer_hook = lambda i, t: None
    hooked = net(torch.from_numpy(x))
    net.layer_hook = None
    assert len(cats) == len(routes)
    for o, h in zip(heads, hooked):
        assert torch.equal(o, h)


def test_detector_matches_jax():
    """``Detector.load("yolov4-csp", device="cpu")`` against the JAX
    ``Detector`` with its Pallas kernels (interpret mode) on two 480x640
    frames at 64: set agreement 1.0."""
    frames = np.random.default_rng(0).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    ref = pj.Detector.load("yolov4-csp", use_pallas=True).detect_batch(frames, size=SIZE,
                                                                       conf=0.5, iou=0.4)
    ours = pt.Detector.load("yolov4-csp", device="cpu").detect_batch(frames, size=SIZE, conf=0.5,
                                                                      iou=0.4)
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    for a, b in zip(ref, ours):
        np.testing.assert_array_equal(b.cls_id, a.cls_id)
        assert np.abs(b.boxes - a.boxes).max() <= 0.5


@pytest.mark.parametrize("size", [640, 512])
def test_letterbox_matches_jax(size):
    """480x640 frames into yolov4x-mish's 640 (the long side scaled by
    exactly 1.0) and yolov4-csp's 512 (by 0.8)."""
    imgs = np.random.default_rng(size).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    geo = tpre.letterbox_geometry(480, 640, size)
    assert geo == jpre.letterbox_geometry(480, 640, size)
    assert geo.scale == size / 640
    ref = np.asarray(jpre.letterbox_batch(jnp.asarray(imgs), size=size))
    ours = tpre.letterbox_batch(torch.from_numpy(imgs), size)
    assert tuple(ours.shape) == (2, size, size, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", list(CSP_CONV_CASES))
def test_conv_bf16_plain_matches_jax_conv(name):
    """K5's plain version against JAX's ``_conv`` in bf16 at the 3->40 stem
    and the C = 40 / 80 3x3 convs (the packed and "im2col16" routes), the
    C = 80 1x1 conv and the logistic heads of the family, each
    at a reduced spatial size (24², or 48² before a stride-2 conv)."""
    n, h, w, *rest = CSP_CONV_CASES[name]
    side = 48 if rest[3] == 2 else 24
    x, w_, b, stride, pad, act, sc = conv_bf16_input(name, case=(n, side, side, *rest))
    ours = tk.conv_bf16(x, w_, b, stride, pad, act, sc)
    ref = _jax_conv(x.float().numpy(), w_.float().numpy(), b.numpy(), stride, pad, act,
                    None if sc is None else sc.float().numpy())
    assert tuple(ours.shape) == ref.shape
    equal, ulps = bf16_agreement(ours, torch.from_numpy(ref.copy()),
                                 conv_bf16_floor(x, w_, b, stride, pad, sc))
    assert equal >= 0.999 and ulps <= 1, (name, equal, ulps)


@pytest.mark.parametrize("name,size", [("yolov4-csp", 512), ("yolov4x-mish", 640)])
def test_decode_new_coords_heads_match_pallas(name, size):
    """K1's plain version on the model's three new_coords heads (scale_x_y
    2.0, values a logistic conv already squashed) at the grids of its
    published size, against JAX's Pallas decode in interpret mode, and in
    one call over the three heads (``decode_score_all``)."""
    spec = model_spec(name)
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(_GENERATORS[name]()))
    rng = np.random.default_rng(size)
    raws, refs = [], []
    for h, jh, s in zip(spec.yolo_layers, jspec.yolo_layers, tcfg.head_strides(spec)):
        anchors, cls_act, sxy, nc = head_decode_args(h, s)
        assert (anchors, cls_act, sxy, nc) == j_head_decode_args(jh, s)
        assert (cls_act, sxy, nc) == ("linear", 2.0, True)
        raw = rng.uniform(0, 1, (1, size // s, size // s, 255)).astype(np.float32)
        ref = np.asarray(jpk.decode_score_head(jnp.asarray(raw), anchors, s, h.classes,
                                               cls_act=cls_act, scale_xy=sxy, new_coords=nc,
                                               interpret=True))
        ours = tk.decode_score_head(torch.from_numpy(raw), anchors, s, h.classes,
                                    cls_act=cls_act, scale_xy=sxy, new_coords=nc)
        assert_rows_close(ours.numpy(), ref)
        raws.append(torch.from_numpy(raw))
        refs.append(ref)
    rows = tk.decode_score_all(tuple(raws), spec)
    assert rows.shape[1] == 3 * sum((size // s) ** 2 for s in (8, 16, 32))
    assert_rows_close(rows.numpy(), np.concatenate(refs, 1))


@pytest.mark.parametrize("name,routes,int8", [
    ("yolov4-csp", {"tma": 71, "im2col": 41, "im2col32": 2, "packed": 1}, (61, 37, 13)),
    ("yolov4x-mish", {"tma": 83, "im2col": 32, "im2col_pad": 17, "packed": 1, "im2col16": 6},
     (72, 48, 13)),
])
def test_family_plans(name, routes, int8):
    """What the family sends to each kernel: K5's route for every conv of
    the bf16 model (yolov4x-mish's six C % 32 != 0 convs on 16-channel
    boxes: layers 1, 3, 5, 10, 13, 16; its 3->40 stem on the packed route),
    and int8sb's convs (default skip): 1x1 stride-1 on K3, the rest on K4,
    none on the ``mma.sync`` core, and the split-concat convs that
    ``concat_split_groups`` lists among them."""
    spec = model_spec(name)
    plans = {l.index: tk.conv_bf16_plan(l.in_channels, l.filters, l.size, l.size, l.stride,
                                        l.padding)
             for l in spec.layers if isinstance(l, tcfg.ConvSpec)}
    assert dict(collections.Counter(p[0] for p in plans.values())) == routes
    boxed = sorted(i for i, p in plans.items() if p[0] == "im2col16")
    assert boxed == ([1, 3, 5, 10, 13, 16] if "im2col16" in routes else [])
    skip = tq.resolve_skip_layers(spec, "heads",
                                  default_min_stride=tq.default_early_min_stride(spec))
    q = [l for l in spec.layers if isinstance(l, tcfg.ConvSpec) and l.index not in skip]
    k3 = [l for l in q if l.size == 1 and l.stride == 1]
    assert (len(k3), len(q) - len(k3)) == int8[:2]
    assert all(tk.igemm_plan(l.in_channels, [0, l.in_channels], l.filters, False, True,
                             l.size, l.size, l.stride, l.padding)[0] == "wgmma" for l in q)
    split = tq.concat_split_groups(spec)
    assert sum(1 for l in q if l.index in split) == int8[2]

"""yolov4 and yolov4-tiny through the port against the JAX package, on the CPU.

The two upstream-pinned YOLOv4 models bring the layers yolov3 lacks: mish
convs with their [shortcut] in the epilogue, the SPP block (three stride-1
maxpools and the four-source route 113), the CSP routes, scale_x_y heads,
and yolov4-tiny's split routes (``groups=2``) and maxpool ladder.  Both
sides get the JAX package's ``random_raw_params`` + ``fold_batchnorm`` (the
port's copy draws the same numbers) and the same numpy inputs; the port's
kernels run their plain versions.

Tolerances, each with its reason:
  * the fp32 forward of yolov4@64 (110 convs, He-init: heads reach ~470):
    |ours - JAX| <= 1e-5 max|JAX| + 1e-5 a head.  torch's mish differs from
    XLA's in the last ulps (about half of all inputs), and 110 He-init
    layers carry those ulps on (measured 8.4e-4 on 473, 1.8e-6 of the
    head's scale); yolov4-tiny@96 (leaky only): rtol = atol = 1e-4, as
    ``tests/test_torch_forward.py``;
  * w8a8 with every conv int8, static scales from JAX's
    ``collect_act_scales`` or dynamic ones: bit for bit.  The int8 sums are
    exact, the epilogue's multiply-adds are fused as XLA fuses them, and on
    the CPU the epilogue's mish is XLA's (``ops/xla_mish.py``), which
    ``test_xla_mish_matches_jax`` holds bit for bit on its own;
  * yolov4 with the default skip (the heads and the stride-8 early skip:
    21 fp32 mish convs): the fp32 bound above, for the same ulps;
  * ``Detector`` end to end, fp32: set agreement 1.0, as
    ``tests/test_torch_slice.py``;
  * the variance equalizer on yolov4 (72 mish convs) at a 64-pixel probe:
    the same sweeps, kernels within rtol 1e-4, as ``tests/test_torch_live.py``
    holds yolov3-tiny (measured 2.9e-6).
"""

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
from pytorch_yolo_tpu.ops import quant as jq
import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch import weights as tw
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import quant as tq
from pytorch_yolo_tpu_torch.ops.xla_mish import mish_factor
from pytorch_yolo_tpu_torch.utils.drift import detection_drift
from pytorch_yolo_tpu_torch.weights import params_from_jax
from tests.test_torch_live import _jax_equalize
from tests.test_torch_quantize_i8 import _float_cats
from tests.torch_threads import one_torch_thread  # noqa: F401

# model -> (input size, batch)
MODELS = {"yolov4": (64, 1), "yolov4-tiny": (96, 2)}


@pytest.fixture(scope="module", params=list(MODELS))
def model(request):
    """(name, JAX spec, port spec, JAX numpy params, port params, input,
    JAX static scales) of one model."""
    name = request.param
    size, batch = MODELS[name]
    text = _GENERATORS[name]()
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    jp = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=3))
    jp = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jp.items()}
    x = np.random.default_rng(3).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    act = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x)
    return name, jspec, tspec, jp, params_from_jax(jp), x, act


def _jax_heads(jspec, params, x, quant=None):
    fwd = jax.jit(jdn.build_forward(jspec, quant=quant))
    return [np.asarray(h) for h in fwd(jax.tree_util.tree_map(jnp.asarray, params),
                                       jnp.asarray(x))]


def _assert_heads(ours, ref, exact, name=""):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        o = o.numpy()
        assert o.dtype == np.float32 and o.shape == r.shape
        if exact:
            np.testing.assert_array_equal(o, r, err_msg=name)
        elif name == "yolov4-tiny":
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4)
        else:
            bound = 1e-5 * np.abs(r).max() + 1e-5
            assert np.abs(o - r).max() <= bound, (name, np.abs(o - r).max(), bound)


def test_xla_mish_matches_jax():
    """The CPU epilogue's mish factor against XLA's compiled mish on 2^23
    values over six scales (and zeros, subnormals, +-88, +-200): bit for
    bit; torch's own mish differs on about half of them."""
    rng = np.random.default_rng(0)
    y = np.concatenate([rng.normal(0, s, 1 << 20) for s in (0.01, 0.3, 1, 3, 10, 100)]
                       + [rng.uniform(-90, 90, 1 << 21)]).astype(np.float32)
    y[:10] = [0.0, -0.0, 1e-30, -1e-30, 88.0, -88.0, 200.0, -200.0, 1e-40, -1e-40]
    ref = np.asarray(jax.jit(lambda v: jdn.apply_activation(v, "mish"))(jnp.asarray(y)))
    yt, t = mish_factor(torch.from_numpy(y))
    np.testing.assert_array_equal((yt * t).numpy().view(np.uint32), ref.view(np.uint32))
    torch_mish = tdn.apply_activation(torch.from_numpy(y), "mish").numpy()
    assert (torch_mish != ref).mean() > 0.3


def test_fp32_forward_matches_jax(model):
    name, jspec, tspec, jp, tp, x, _ = model
    ref = _jax_heads(jspec, jp, x)
    ours = tdn.Darknet(tspec, tp)(torch.from_numpy(x))
    assert tuple(tuple(h.shape) for h in ours) == tdn.head_shapes(tspec, x.shape[1], x.shape[0])
    _assert_heads(ours, ref, exact=False, name=name)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_every_conv_int8_matches_jax_bit_for_bit(model, scales):
    """w8a8 with no conv skipped: the heads equal JAX's bit for bit, with
    JAX's static scales (int8-resident chains) and with dynamic ones."""
    name, jspec, tspec, jp, tp, x, act = model
    act = act if scales == "static" else None
    ref = _jax_heads(jspec, jq.quantize_params(jspec, jp, (), act), x, quant="w8a8")
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, (), act), quant="w8a8")
    assert not net.convs and len(net.qconvs) == {"yolov4": 110, "yolov4-tiny": 21}[name]
    assert bool(net._chains) == (scales == "static")
    _assert_heads(net(torch.from_numpy(x)), ref, exact=True, name=name)


@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_default_skip_int8_matches_jax(model, scales):
    """w8a8 with the JAX package's default skip for the topology
    (``default_early_min_stride``: 8 for yolov4, 0 for the tiny ladder):
    yolov4 keeps 21 fp32 convs (the stride-8 early skip and the heads),
    whose mish gives the fp32 bound; yolov4-tiny keeps its heads, whose
    fp32 sums differ from XLA's in their order."""
    name, jspec, tspec, jp, tp, x, act = model
    act = act if scales == "static" else None
    early = tq.default_early_min_stride(tspec)
    assert early == {"yolov4": 8, "yolov4-tiny": 0}[name]
    skip = jq.resolve_skip_layers(jspec, "heads", default_min_stride=early)
    assert skip == tq.resolve_skip_layers(tspec, "heads", default_min_stride=early)
    ref = _jax_heads(jspec, jq.quantize_params(jspec, jp, skip, act), x, quant="w8a8")
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, skip, act), quant="w8a8")
    assert len(net.qconvs) == {"yolov4": 89, "yolov4-tiny": 19}[name]
    ours = net(torch.from_numpy(x))
    if name == "yolov4":
        _assert_heads(ours, ref, exact=False, name=name)
    else:  # the fp32 head convs sum in oneDNN's order: the fp32 forward's bound
        for o, r in zip(ours, ref):
            np.testing.assert_allclose(o.numpy(), r, rtol=1e-4, atol=1e-4)


def test_spp_route_read_through_matches_jax(monkeypatch):
    """yolov4's int8 forward at JAX's static scales with every conv int8:
    every multi-source route, SPP's four-source route 113 included, is read
    through by the next conv's K6 (the plain version here) with no
    ``torch.cat`` of its sources, and the heads are JAX's bits; a layer hook
    brings the copies back and the same heads."""
    size, batch = MODELS["yolov4"]
    text = _GENERATORS["yolov4"]()
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    jp = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=5))
    jp = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jp.items()}
    x = np.random.default_rng(5).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)
    act = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x)
    ref = _jax_heads(jspec, jq.quantize_params(jspec, jp, (), act), x, quant="w8a8")
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, params_from_jax(jp), (), act),
                      quant="w8a8")
    routes = {l.index for l in tspec.layers if isinstance(l, tcfg.RouteSpec) and len(l.layers) > 1}
    assert net._read_through == routes and 113 in routes
    assert len(tspec.layers[113].layers) == 4 == tk.MAX_SPLIT_GROUPS
    cats = _float_cats(monkeypatch)
    heads = net(torch.from_numpy(x))
    assert cats == []
    _assert_heads(heads, ref, exact=True, name="yolov4")
    net.layer_hook = lambda i, t: None
    hooked = net(torch.from_numpy(x))
    net.layer_hook = None
    assert len(cats) == len(routes)
    for o, h in zip(heads, hooked):
        assert torch.equal(o, h)


def test_detector_matches_jax():
    """``Detector.load("yolov4-tiny", device="cpu")`` against the JAX
    ``Detector`` on two 480x640 frames at 96: set agreement 1.0."""
    frames = np.random.default_rng(0).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    ref = pj.Detector.load("yolov4-tiny", use_pallas=True).detect_batch(frames, size=96,
                                                                        conf=0.5, iou=0.4)
    ours = pt.Detector.load("yolov4-tiny", device="cpu").detect_batch(frames, size=96, conf=0.5,
                                                                       iou=0.4)
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    for a, b in zip(ref, ours):
        np.testing.assert_array_equal(b.cls_id, a.cls_id)
        assert np.abs(b.boxes - a.boxes).max() <= 1e-2


def test_equalize_matches_jax_on_yolov4():
    """``equalize_raw_params`` on a mish model: the port's sweeps and
    rescaled kernels against JAX's at a 64-pixel probe."""
    text = _GENERATORS["yolov4"]()
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    ref, forwards = _jax_equalize(jspec, jw.random_raw_params(jspec), size=64)
    info = {}
    ours = tw.equalize_raw_params(tspec, tw.random_raw_params(tspec), size=64, device="cpu",
                                  info=info)
    assert info["converged"] and info["sweeps"] + 1 == forwards and info["unscaled"] == []
    for i, r in ref.items():
        np.testing.assert_allclose(ours[i]["w"], r["w"].transpose(3, 2, 0, 1), rtol=1e-4)


def test_letterbox_608_matches_jax():
    """Path A's letterbox: 480x640 uint8 frames to yolov4's published 608,
    within 1e-5 of JAX's, as ``tests/test_torch_letterbox.py`` holds 416."""
    from pytorch_yolo_tpu.ops import preprocess as jpre
    from pytorch_yolo_tpu_torch.ops import preprocess as tpre

    imgs = np.random.default_rng(608).integers(0, 256, (2, 480, 640, 3), dtype=np.uint8)
    ref = np.asarray(jpre.letterbox_batch(jnp.asarray(imgs), size=608))
    ours = tpre.letterbox_batch(torch.from_numpy(imgs), 608)
    assert tuple(ours.shape) == (2, 608, 608, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)

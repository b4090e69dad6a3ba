"""yolov3-spp, yolov2 and yolov2-tiny through the port against the JAX package, on the CPU.

The last three families of the zoo (``models/zoo.py: yolov3_spp_cfg``,
``yolov2_cfg``, ``yolov2_tiny_cfg``) bring what no earlier model ran:
Darknet's ``[reorg]`` channel shuffle on an int8 conv's fp32 output and
route 28 of yolov2, whose sources (the reorg and conv 24) the next int8
conv's K6 reads in place of their concatenation; the ``[region]`` head
(five anchors in grid units, a softmax over the classes); the v2 maxpool
ladders, whose early skip is 0, so the int8 RGB stem and the int8 pools
(yolov2-tiny's 2x2 stride-1 pool at layer 11 among them) run on resident
int8; and SPP in a leaky Darknet-53 (yolov3-spp's route 83 of four
512-channel sources).  Both sides get the JAX package's
``random_raw_params`` + ``fold_batchnorm`` and the same numpy inputs; the
port's kernels run their plain versions.  Each model's params are built
once for the module, at 64 pixels (yolov2's reorg then runs on 4² -> 2²).
The v2 pair's fp32 forwards at 64 are also cases of
``tests/test_torch_forward.py: test_forward_matches_jax`` (rtol = atol =
1e-4 an element); yolov3-spp's heads reach ~10^4 there, where that bound
does not hold for a He-init Darknet-53 (yolov3's own differ by up to 37 %
of an element near zero), so its forward is held here alone.

Tolerances, each with its reason (those of ``tests/test_torch_large.py``;
leaky, linear and the softmax head need no XLA emulation):
  * the fp32 forwards (He-init): |ours - JAX| <= 1e-5 max|JAX| + 1e-5 a
    head, yolov4's bound: oneDNN and XLA sum the convs in different orders
    and 76 layers carry the ulps on (yolov3-spp: 0.029 on heads of ~10^4);
  * every conv int8, at JAX's static scales and at dynamic ones: bit for
    bit, every conv's output (taken through ``collect_conv_out_stats`` on
    both sides; the hook concatenates the routes again) and the unhooked
    heads, whose forward reads route 28 (yolov2) and route 83 (yolov3-spp)
    through with no float ``torch.cat``;
  * the default skip (threshold 0 on the v2 pair: only the head conv stays
    fp32; 8 on yolov3-spp: 13 fp32 convs): each conv on JAX's own input to
    it, the int8 convs bit for bit and the fp32 ones within 1e-5 of their
    output's scale (+ 1e-5).  End to end an ulp of an fp32 conv (oneDNN's
    summation order) can cross a rounding boundary of the next int8 conv's
    quantizer;
  * ``Detector`` end to end, fp32: set agreement 1.0 and boxes within half
    a pixel of the 640-pixel frame, as ``tests/test_torch_large.py``;
  * K5's plain version against JAX's ``_conv`` in bf16: >= 99.9 % of
    outputs bit-equal and the rest within one bf16 step or the fp32 sum's
    order error, as ``tests/test_torch_conv_bf16.py``;
  * K1's plain version against JAX's Pallas decode in interpret mode on a
    softmax ``[region]`` head: rows within 1e-6 (box columns relative to
    the row's largest corner), ``cls_id`` exact;
  * the variance equalizer: the same sweeps, kernels within rtol 1e-4, as
    ``tests/test_torch_live.py``.

The module runs the port on one intra-op thread, as the CSP and large
files do.
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
from pytorch_yolo_tpu.ops import quant as jq
from pytorch_yolo_tpu.ops.decode import head_decode_args as j_head_decode_args
import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch import weights as tw
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.models import zoo as tzoo
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import quant as tq
from pytorch_yolo_tpu_torch.ops.decode import head_decode_args
from pytorch_yolo_tpu_torch.utils.drift import detection_drift
from pytorch_yolo_tpu_torch.weights import params_from_jax
from tests.test_torch_conv_bf16 import _jax_conv
from tests.test_torch_cuda import (V2_CONV_CASES, assert_rows_close, bf16_agreement,
                                   conv_bf16_floor, conv_bf16_input)
from tests.test_torch_live import _jax_equalize
from tests.test_torch_quantize_i8 import _float_cats
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = 64
MODELS = ("yolov3-spp", "yolov2", "yolov2-tiny")
# model -> the multi-source routes its int8 forward reads through
READ_THROUGH = {"yolov3-spp": {83, 93, 105}, "yolov2": {28}, "yolov2-tiny": set()}


@pytest.fixture(scope="module")
def model(request):
    """(name, JAX spec, port spec, JAX numpy params, port params, input) of
    the model ``request.param`` at 64 pixels.  Tests take it through
    indirect parametrization, so pytest runs each model's tests together
    and frees its params before it builds the next model's."""
    name = request.param
    text = jzoo._GENERATORS[name]()
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    jp = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=3))
    jp = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jp.items()}
    x = np.random.default_rng(3).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    yield name, jspec, tspec, jp, params_from_jax(jp), x
    del jp
    gc.collect()


def _jax_forward(jspec, params, x, quant=None, **kw):
    fwd = jax.jit(jdn.build_forward(jspec, quant=quant, **kw))
    return fwd(jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))


def _static_scales(jspec, jp, x):
    return jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x)


@pytest.mark.parametrize("model", MODELS, indirect=True)
def test_fp32_forward_matches_jax(model):
    """The fp32 forward at 64: one [region] head of 425 channels at 2²
    (the v2 pair) or three [yolo] heads at 2², 4² and 8² (yolov3-spp, whose
    SPP pools of 5, 9 and 13 pad a 2x2 map), within yolov4's bound."""
    name, jspec, tspec, jp, tp, x = model
    ref = [np.asarray(h) for h in _jax_forward(jspec, jp, x)]
    with torch.no_grad():
        ours = tdn.Darknet(tspec, tp)(torch.from_numpy(x))
    shapes = tdn.head_shapes(tspec, SIZE, 2)
    assert tuple(tuple(h.shape) for h in ours) == shapes
    assert [s[-1] for s in shapes] == ([255] * 3 if name == "yolov3-spp" else [425])
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        bound = 1e-5 * np.abs(r).max() + 1e-5
        assert np.abs(o.numpy() - r).max() <= bound, (name, np.abs(o.numpy() - r).max(), bound)


@pytest.mark.parametrize("model", MODELS, indirect=True)
@pytest.mark.parametrize("scales", ["static", "dynamic"])
def test_every_conv_int8_matches_jax_bit_for_bit(model, scales, monkeypatch):
    """w8a8 with no conv skipped (76, 23 or 9 int8 convs, the head conv
    among them), at JAX's static scales (int8-resident chains: the v2
    ladders' int8 stems and maxpools, yolov2-tiny's 2x2 stride-1 pool at
    13² → 2² here) or dynamic ones: every conv's output and the heads equal
    JAX's bit for bit.  yolov2's conv 26 writes fp32 (the reorg is not
    int8-transparent), the reorg shuffles it, and conv 29's K6 reads route
    28's two sources (256 + 1024 channels) with no concatenated copy."""
    name, jspec, tspec, jp, tp, x = model
    act = _static_scales(jspec, jp, x) if scales == "static" else None
    qp = jq.quantize_params(jspec, jp, (), act)
    jheads, jouts = _jax_forward(jspec, qp, x, "w8a8", collect_conv_out_stats=lambda i, t: t)
    jplain = [np.asarray(h) for h in _jax_forward(jspec, qp, x, "w8a8")]
    del qp
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, (), act), quant="w8a8")
    convs = [l.index for l in tspec.layers if isinstance(l, tcfg.ConvSpec)]
    assert not net.convs and sorted(net._qconv_at) == convs
    assert len(convs) == {"yolov3-spp": 76, "yolov2": 23, "yolov2-tiny": 9}[name]
    assert bool(net._chains) == (scales == "static")
    if scales == "static" and name != "yolov3-spp":  # the ladder: conv -> maxpool -> conv
        assert net._chains[0] == 2 and 26 not in net._chains
        assert name == "yolov2" or net._chains[10] == 12  # through the 2x2 s1 pool 11
    assert net._read_through == READ_THROUGH[name]
    with torch.no_grad():
        heads, outs = net(torch.from_numpy(x), collect_conv_out_stats=lambda i, t: t.clone())
        cats = _float_cats(monkeypatch)
        plain = net(torch.from_numpy(x))
    assert cats == []
    assert sorted(outs) == sorted(jouts) == convs
    for i in convs:
        np.testing.assert_array_equal(outs[i].numpy(), np.asarray(jouts[i]), err_msg=f"conv {i}")
    for o, h, r, rp in zip(plain, heads, jheads, jplain):
        np.testing.assert_array_equal(h.numpy(), np.asarray(r))
        np.testing.assert_array_equal(o.numpy(), rp)


@pytest.mark.parametrize("model", MODELS, indirect=True)
def test_default_skip_int8_matches_jax(model):
    """w8a8 at the default skip for the topology: threshold 0 on the v2
    ladders (22 and 8 int8 convs, the head conv fp32) and 8 on yolov3-spp
    (63 int8, 13 fp32), each conv on JAX's own input to it (static scales,
    resident int8 where the chain gives it): the int8 convs bit for bit,
    the fp32 ones within 1e-5 of their output's scale (+ 1e-5)."""
    name, jspec, tspec, jp, tp, x = model
    early = tq.default_early_min_stride(tspec)
    assert early == jq.default_early_min_stride(jspec) == (8 if name == "yolov3-spp" else 0)
    skip = jq.resolve_skip_layers(jspec, "heads", default_min_stride=early)
    assert skip == tq.resolve_skip_layers(tspec, "heads", default_min_stride=early)
    act = _static_scales(jspec, jp, x)
    qp = jq.quantize_params(jspec, jp, skip, act)
    _, ins = _jax_forward(jspec, qp, x, "w8a8", collect_conv_in_stats=lambda i, t: t)
    _, outs = _jax_forward(jspec, qp, x, "w8a8", collect_conv_out_stats=lambda i, t: t)
    del qp
    net = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, skip, act), quant="w8a8")
    assert (len(net.qconvs), len(net.convs)) == {"yolov3-spp": (63, 13), "yolov2": (22, 1),
                                                 "yolov2-tiny": (8, 1)}[name]
    int8_in = 0
    with torch.no_grad():
        for layer in tspec.layers:
            if not isinstance(layer, tcfg.ConvSpec):
                continue
            i = layer.index
            xin = torch.from_numpy(np.array(ins[i])).permute(0, 3, 1, 2)
            int8_in += xin.dtype == torch.int8
            ref = np.asarray(outs[i])
            if i in skip:
                ours = net._run_conv(net._conv_at[i], xin).permute(0, 2, 3, 1).numpy()
                bound = 1e-5 * np.abs(ref).max() + 1e-5
                assert np.abs(ours - ref).max() <= bound, (i, np.abs(ours - ref).max(), bound)
            else:
                ours = net._quantized(xin, layer).permute(0, 2, 3, 1).numpy()
                assert ours.dtype == ref.dtype
                np.testing.assert_array_equal(ours, ref, err_msg=f"conv {i}")
    assert int8_in == len(net._chains) > 0


@pytest.mark.parametrize("model", ["yolov3-spp", "yolov2"], indirect=True)
def test_detector_matches_jax(model):
    """``Detector`` end to end, fp32, at 128 on two 480x640 frames: the
    port's CPU detector against the JAX ``Detector`` with its Pallas
    kernels (interpret mode), both on the module's params: set agreement
    1.0.  yolov2's [region] head goes through K1's softmax branch,
    yolov3-spp's three [yolo] heads through one K1 call."""
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


@pytest.mark.parametrize("name,size", [("yolov2", 416), ("yolov2-tiny", 608)])
def test_decode_region_softmax_matches_pallas(name, size):
    """K1's plain version on the model's [region] head (five anchors in grid
    units, a softmax over 80 classes, 425 channels) against JAX's Pallas
    decode in interpret mode, alone and through ``decode_score_all``:
    845 rows a frame at 416, 1,805 at 608."""
    spec, jspec = tzoo.model_spec(name), jzoo.model_spec(name)
    (head,), (jhead,) = spec.yolo_layers, jspec.yolo_layers
    (stride,) = tcfg.head_strides(spec)
    anchors, cls_act, sxy, nc = head_decode_args(head, stride)
    assert (anchors, cls_act, sxy, nc) == j_head_decode_args(jhead, stride)
    assert (len(anchors), cls_act, nc, type(head).__name__) == (5, "softmax", False,
                                                                "RegionSpec")
    g = size // stride
    raw = np.random.default_rng(size).normal(0, 2, (2, g, g, 425)).astype(np.float32)
    ref = np.asarray(jpk.decode_score_head(jnp.asarray(raw), anchors, stride, head.classes,
                                           cls_act=cls_act, scale_xy=sxy, new_coords=nc,
                                           interpret=True))
    ours = tk.decode_score_head(torch.from_numpy(raw), anchors, stride, head.classes,
                                cls_act=cls_act, scale_xy=sxy, new_coords=nc)
    assert ref.shape == (2, 5 * g * g, 8)
    assert_rows_close(ours.numpy(), ref)
    assert_rows_close(tk.decode_score_all((torch.from_numpy(raw),), spec).numpy(), ref)


@pytest.mark.parametrize("name", list(V2_CONV_CASES))
def test_conv_bf16_plain_matches_jax_conv(name):
    """K5's plain version against JAX's ``_conv`` in bf16 at the three
    models' new shapes (yolov2's 3x3 1280 -> 1024 conv 29 after the reorg
    route, the [region] head conv, yolov2-tiny's C = 16 "im2col16" conv and its
    stride-1 stem, yolov3-spp's 2048 -> 512 conv after route 83), each at a
    reduced spatial size (at most 24²), on the route ``conv_bf16_plan``
    names."""
    route, (n, h, w, *rest) = V2_CONV_CASES[name]
    side = min(h, 24)
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


def test_equalize_matches_jax_on_yolov2():
    """``equalize_raw_params`` on a [region] model with a reorg route: the
    port's sweeps and rescaled kernels against JAX's at a 64-pixel probe."""
    text = jzoo._GENERATORS["yolov2"]()
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    ref, forwards = _jax_equalize(jspec, jw.random_raw_params(jspec), size=64)
    info = {}
    ours = tw.equalize_raw_params(tspec, tw.random_raw_params(tspec), size=64, device="cpu",
                                  info=info)
    assert info["converged"] and info["sweeps"] + 1 == forwards and info["unscaled"] == []
    for i, r in ref.items():
        np.testing.assert_allclose(ours[i]["w"], r["w"].transpose(3, 2, 0, 1), rtol=1e-4)


# name -> K5 routes of the bf16 model; int8sb (default skip): K3, K4, K5
# convs, the int8 convs on K4's packed route (the C = 3 stem of a ladder),
# the int8 convs after a concat route with their split groups; the early
# threshold
PLANS = {
    "yolov3-spp": ({"tma": 38, "im2col": 35, "im2col32": 2, "packed": 1}, (32, 31, 13), [],
                   {84: (512,) * 4, 94: (256, 512), 106: (128, 256)}, 8),
    "yolov2": ({"tma": 8, "im2col": 13, "im2col32": 1, "packed": 1}, (7, 15, 1), [0],
               {29: (256, 1024)}, 0),
    "yolov2-tiny": ({"tma": 1, "im2col": 5, "im2col32": 1, "im2col16": 1, "packed": 1},
                    (0, 8, 1), [0], {}, 0),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_family_plans(name):
    """What each model sends to each kernel at its published size: the
    generator's text equal to the JAX package's, K5's route for every conv
    of the bf16 model, and int8sb's convs at the default skip, whose set
    and early threshold equal the JAX package's: 1x1 stride-1 on K3, the
    rest on K4, the RGB stem of the v2 ladders on K4's packed route (C = 3)
    and none on the ``mma.sync`` core, the split-concat convs (yolov2's conv 29 on 256 + 1024 after
    the reorg route), the int8-resident chains, and the pools."""
    routes, (k3n, k4n, k5n), packed, split, early = PLANS[name]
    assert tzoo._GENERATORS[name]() == jzoo._GENERATORS[name]()
    spec, jspec = tzoo.model_spec(name), jzoo.model_spec(name)
    convs = [l for l in spec.layers if isinstance(l, tcfg.ConvSpec)]
    plans = {l.index: tk.conv_bf16_plan(l.in_channels, l.filters, l.size, l.size, l.stride,
                                        l.padding) for l in convs}
    assert dict(collections.Counter(p[0] for p in plans.values())) == routes
    assert tq.default_early_min_stride(spec) == jq.default_early_min_stride(jspec) == early
    skip = tq.resolve_skip_layers(spec, "heads", default_min_stride=early)
    assert skip == jq.resolve_skip_layers(jspec, "heads", default_min_stride=early)
    q = [l for l in convs if l.index not in skip]
    k3 = [l for l in q if l.size == 1 and l.stride == 1]
    assert (len(k3), len(q) - len(k3), len(convs) - len(q)) == (k3n, k4n, k5n)
    cores = {l.index: tk.igemm_plan(l.in_channels, [0, l.in_channels], l.filters, False,
                                    True, l.size, l.size, l.stride, l.padding)[0] for l in q}
    assert sorted(i for i, c in cores.items() if c == "packed") == packed
    assert "mma" not in cores.values()
    groups = tq.concat_split_groups(spec)
    assert groups == jq.concat_split_groups(jspec)
    assert {l.index: groups[l.index] for l in q if l.index in groups} == split
    act = {l.index: 0.05 for l in q}
    fake = {l.index: ({"wq": 0, "sa": 0.05} if l.index in act else {"w": 0}) for l in convs}
    assert tq.int8_resident_chains(spec, fake) == jq.int8_resident_chains(jspec, fake)
    pools = [(l.size, l.stride) for l in spec.layers if isinstance(l, tcfg.MaxPoolSpec)]
    assert pools == {"yolov3-spp": [(5, 1), (9, 1), (13, 1)],
                     "yolov2": [(2, 2)] * 5,
                     "yolov2-tiny": [(2, 2)] * 5 + [(2, 1)]}[name]

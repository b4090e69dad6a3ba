"""Live synthetic weights, the stem policy and ``score_mode``: the port
against the JAX package on the CPU.

``equalize_raw_params`` (LSUV variance equalization, ``synthetic="live"``)
is held to the JAX function on yolov3-tiny and the mini CSP cfg: the same
number of sweeps and kernels within rtol 1e-4 (each sweep divides by stds
that the two fp32 forwards agree on to ~1e-6; measured 1e-6).  The port's
one divergence, the factor an unbounded conv too quiet to rescale passes
on, is recorded on a constructed case, and asserted not to occur on the
two real cfgs.  A live yolov3-tiny detector agrees with JAX's at fp32 /
"highest" with set agreement 1.0, as the He-init slice does.
"""

import functools
import os

import numpy as np
import pytest
import torch

import pytorch_yolo_tpu as pj
from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu import weights as jw
import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch import weights as tw
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.utils.drift import detection_drift
from tests.test_new_coords import MINI_CSP_CFG
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")
FRAMES = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)


def _text(name):
    if name == "mini-csp":
        return MINI_CSP_CFG
    with open(os.path.join(ROOT, "cfg", f"{name}.cfg"), encoding="utf-8") as f:
        return f.read()


def _specs(text):
    return jcfg.build_spec(jcfg.parse_cfg_text(text)), tcfg.build_spec(tcfg.parse_cfg_text(text))


def _jax_equalize(jspec, raw, **kw):
    """JAX's ``equalize_raw_params`` and the number of forwards it ran (it
    refolds BN once a forward)."""
    calls = []
    fold = jw.fold_batchnorm

    def counting(*a, **k):
        calls.append(1)
        return fold(*a, **k)

    jw.fold_batchnorm = counting
    try:
        out = jw.equalize_raw_params(jspec, raw, **kw)
    finally:
        jw.fold_batchnorm = fold
    return out, len(calls)


@pytest.mark.parametrize("name", ["yolov3-tiny", "mini-csp"])
def test_equalize_matches_jax(name):
    jspec, tspec = _specs(_text(name))
    ref, forwards = _jax_equalize(jspec, jw.random_raw_params(jspec))
    info = {}
    ours = tw.equalize_raw_params(tspec, tw.random_raw_params(tspec), device="cpu", info=info)
    assert info["converged"] and info["max_log_std"] < 0.1
    assert info["sweeps"] + 1 == forwards  # the converged sweep measures and stops
    assert info["unscaled"] == []  # the divergent branch is not taken here
    for i, r in ref.items():
        np.testing.assert_allclose(ours[i]["w"], r["w"].transpose(3, 2, 0, 1), rtol=1e-4)
        for k in r:
            if k != "w":
                np.testing.assert_array_equal(ours[i][k], r[k])  # BN and biases untouched


def test_equalize_unscaled_conv_divergence():
    """A conv with a zero kernel and bias (output std 0, so not rescaled)
    between two live convs.  JAX gives it factor 1.0; the port passes its
    input's factor 1 / s0 on, since its unchanged kernel scales with its
    input.  After one sweep the next conv's kernel differs by exactly s0."""
    text = ("[net]\nwidth=64\nheight=64\nchannels=3\n"
            "[convolutional]\nbatch_normalize=1\nfilters=8\nsize=3\nstride=1\npad=1\n"
            "activation=leaky\n"
            "[convolutional]\nfilters=8\nsize=1\nstride=1\npad=1\nactivation=leaky\n"
            "[convolutional]\nbatch_normalize=1\nfilters=16\nsize=3\nstride=2\npad=1\n"
            "activation=leaky\n"
            "[convolutional]\nfilters=255\nsize=1\nstride=1\npad=1\nactivation=linear\n"
            "[yolo]\nmask=0,1,2\nanchors=10,14,23,27,37,58\nclasses=80\nnum=3\n")
    jspec, tspec = _specs(text)
    jraw, traw = jw.random_raw_params(jspec), tw.random_raw_params(tspec)
    for raw in (jraw, traw):
        raw[1]["w"] = np.zeros_like(raw[1]["w"])
        raw[1]["b"] = np.zeros_like(raw[1]["b"])
    ref, _ = _jax_equalize(jspec, jraw, size=64, iters=1)
    info = {}
    ours = tw.equalize_raw_params(tspec, traw, size=64, iters=1, device="cpu", info=info)
    assert info["unscaled"] == [1] and info["sweeps"] == 1
    x = torch.from_numpy(np.random.default_rng(7).random((1, 64, 64, 3), dtype=np.float32))
    _, s = tdn.Darknet(tspec, tw.fold_batchnorm(tspec, traw))(
        x, collect_conv_out_stats=lambda i, t: float(t.std(correction=0)))
    assert abs(s[0] - 1.0) > 0.05 and s[2] > 1e-6
    np.testing.assert_allclose(ours[0]["w"], ref[0]["w"].transpose(3, 2, 0, 1), rtol=1e-4)
    np.testing.assert_allclose(ours[2]["w"] / ref[2]["w"].transpose(3, 2, 0, 1), s[0], rtol=1e-4)


def test_equalize_defaults_to_the_card(monkeypatch):
    _, tspec = _specs(_text("mini-csp"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tw.equalize_raw_params(tspec, tw.random_raw_params(tspec))
    with pytest.raises(RuntimeError, match="is_available"):
        pt.Detector.load(TINY, synthetic="live")
    with pytest.raises(ValueError, match="synthetic regime"):
        pt.Detector.load(TINY, device="cpu", synthetic="lsuv")


def test_live_detector_matches_jax():
    """``synthetic="live"`` yolov3-tiny at fp32: set agreement 1.0 with the
    JAX package's live detector, and scores that are not saturated."""
    ref = pj.Detector.load(TINY, synthetic="live", use_pallas=True).detect_batch(FRAMES, size=416)
    ours = pt.Detector.load(TINY, device="cpu", synthetic="live").detect_batch(FRAMES, size=416)
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    assert stats.ref_sat_frac == 0.0 and stats.ref_score_spread > 0.02, stats.row()


def test_score_mode_matches_jax():
    """``score_mode="obj*cls"`` ranks by objectness times class score, as in
    the JAX Detector; the pipeline cache keys on it."""
    ref = pj.Detector.load(TINY, use_pallas=True, score_mode="obj*cls")
    ours = pt.Detector.load(TINY, device="cpu", score_mode="obj*cls")
    a, b = ref.detect_batch(FRAMES, size=416), ours.detect_batch(FRAMES, size=416)
    stats = detection_drift(a, b)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    plain = pt.Detector.load(TINY, device="cpu").detect_batch(FRAMES, size=416)
    assert [len(d) for d in plain] != [len(d) for d in b] or any(
        not np.array_equal(p.boxes, d.boxes) for p, d in zip(plain, b))
    assert {k.score_mode for k in ours._pipelines} == {"obj*cls"}
    with pytest.raises(ValueError, match="score_mode"):
        pt.Detector.load(TINY, device="cpu", score_mode="cls")


@functools.lru_cache(maxsize=None)
def _folded(name):
    spec = tcfg.build_spec(tcfg.parse_cfg_text(_text(name)))
    return spec, tw.fold_batchnorm(spec, tw.random_raw_params(spec, seed=3))


@pytest.mark.parametrize("mode,packable", [
    ("fp32", ("yolov3", "yolov3-tiny")), ("bf16", ("yolov3", "yolov3-tiny")),
    ("w8a8", ()), ("w8a8_bf16", ("yolov3",))], ids=["fp32", "bf16", "w8a8", "w8a8_bf16"])
def test_stem_s2d_default_and_env_policy(monkeypatch, mode, packable):
    """The port's default is off in every mode: the H100 A/B measured the s2d
    stem slower in bf16, where the JAX package turns it on.
    ``PYTORCH_YOLO_STEM_S2D=1`` turns it on for a Darknet-53 (conv_conv) or
    tiny (conv_pool) stem whose convs stay fp: not where int8 quantizes the
    stem (every int8 tiny; yolov3 with fp32 glue, which keeps no early conv
    fp), and there an explicit True raises.  ``=0`` and an explicit False
    keep it off."""
    kw = {"fp32": {}, "bf16": dict(dtype=torch.bfloat16, precision="default"),
          "w8a8": dict(quant="w8a8"),
          "w8a8_bf16": dict(quant="w8a8", dtype=torch.bfloat16, precision="default")}[mode]

    def s2d(name, **extra):
        det = pt.Detector(*_folded(name), device="cpu", **kw, **extra)
        assert det.model.stem_s2d == det.stem_s2d
        assert ("stem0" in dict(det.model.named_children())) == det.stem_s2d
        return det.stem_s2d

    monkeypatch.delenv("PYTORCH_YOLO_STEM_S2D", raising=False)
    assert not s2d("yolov3") and not s2d("yolov3-tiny")
    if "yolov3" in packable:
        assert s2d("yolov3", stem_s2d=True)
    else:
        with pytest.raises(ValueError, match="int8-quantized"):
            s2d("yolov3", stem_s2d=True)
    monkeypatch.setenv("PYTORCH_YOLO_STEM_S2D", "1")
    assert s2d("yolov3") == ("yolov3" in packable)
    assert s2d("yolov3-tiny") == ("yolov3-tiny" in packable)
    assert not s2d("yolov3", stem_s2d=False)
    monkeypatch.setenv("PYTORCH_YOLO_STEM_S2D", "0")
    assert not s2d("yolov3")


def test_detector_stem_s2d_end_to_end():
    """A yolov3 Detector with the s2d stem finds the natural stem's boxes
    (the JAX test's bounds: rtol 1e-4, atol 1e-3)."""
    spec = tcfg.build_spec(tcfg.parse_cfg_text(_text("yolov3")))
    params = tw.fold_batchnorm(spec, tw.random_raw_params(spec, seed=2))
    base = pt.Detector(spec, params, device="cpu")
    fast = pt.Detector(spec, params, device="cpu", stem_s2d=True)
    assert fast.stem_s2d and not base.stem_s2d
    img = np.random.default_rng(2).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    db, ds = base.detect(img, size=128, conf=0.1), fast.detect(img, size=128, conf=0.1)
    assert len(db) and db.boxes.shape == ds.boxes.shape
    np.testing.assert_allclose(db.boxes, ds.boxes, rtol=1e-4, atol=1e-3)

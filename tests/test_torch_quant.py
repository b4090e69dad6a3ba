"""The port's int8 serving path against the JAX package's, on the CPU.

Both sides get the same numpy params (the JAX package's ``random_raw_params``
+ ``fold_batchnorm``; the port's copy draws the same numbers), the same
numpy inputs and the same uint8 frames.  On the CPU the port's int8 kernels
K3/K4 run their plain torch versions; the JAX side runs XLA (and the int8
probe's Pallas GEMM in interpret mode).

Tolerances, each with its reason:
  * the spec policy, ``quantize_params`` (``wq`` bit-exact, scales equal),
    the resident-chain map and the probe GEMM: exact — same integer and fp32
    arithmetic in the same order;
  * one ``quantized_conv`` with leaky, relu or linear: exact, fp32 or int8
    out.  The int32 accumulators are exact on both sides, and the port's
    epilogue fuses each multiply-add into one rounding where XLA:CPU
    contracts it into an FMA (``ops/kernels.py: fma``);
  * with mish or logistic, fp32 out: rtol = atol = 1e-5, int8 out: at most
    1 apart on at most 0.1 % of the elements — XLA's ``exp``/``log1p``/
    ``tanh`` differ from torch's in the last ulps, and an ulp can move a
    value across a rounding boundary;
  * ``collect_act_scales``: rtol 1e-5 on the max and split scales (a
    tensor's or a branch's maximum, a large value whose relative error the
    two fp32 forwards' summation orders barely move); 1e-4, the fp32
    forward's own bound (``test_torch_forward.py``), on the smoothed
    per-channel grids, whose small channels carry the forward's relative
    error at their own scale;
  * the quantized forward of the leaky yolov3-tiny, on the same input and
    scales: exact with dynamic scales and with static resident chains (the
    fp32 head convs happen to agree bit for bit too); ``w8`` (weight-only,
    fp32 activations) within rtol = atol = 1e-4, the fp forward's own bound;
  * ``Detector`` end to end: ``set_agreement >= 0.995`` on the same scales.
    The letterbox resizes differ in the last ulp (``jax.image.resize`` is
    a matmul, ``F.interpolate`` is not), and an ulp can flip an int8
    rounding.  A port that calibrates itself gets scales within rtol 1e-5 of
    JAX's, not equal (the two fp32 calibration forwards sum in different
    orders); every differing scale moves many int8 roundings, and the
    random He-init model's near-tied scores (5-95 % spread 0.026) let a
    flip swap which of two overlapping boxes NMS keeps: 0.994 measured on
    these frames, held at >= 0.99.
  * percentile scales (the recipe's ranging): JAX / port in
    [1 - 1e-5, 1.00022].  The port takes the exact order statistic; JAX
    bisects for it and lands at most a factor 2^(20/2^16) ~= 1.000212 above
    it (``pytorch_yolo_tpu/ops/quant.py:282-283``); 1e-5 below covers the
    two fp32 forwards;
  * bias-correction deltas on JAX's own quantized params and canvas: per
    conv, max |difference| <= 1e-2 of the conv's largest |delta| (measured
    2e-3).  The fp twins agree to the forward's ~1e-5 relative, but an ulp
    in a conv's fp32 input can flip one int8 rounding of the quantized
    twin, which moves that conv's mean error by a quantization step times a
    weight over N*H*W — most at the 8x8 layers;
  * noise ranks on the same: relative L2 errors within rtol 1e-3 (measured
    1e-4, the same flips) and the same top-4 order;
  * the "auto" detector that calibrates itself, on live-weight yolov3-tiny:
    the port's scales differ from JAX's by up to 2.1e-4 relative (the
    bisection's band), and each side's bias deltas correct the error of its
    own grids.  The test holds the port to JAX as far as JAX is from itself
    with its scales moved at random inside that band (divided by U(1,
    1.000212)), a reading it takes on the spot: heads within 1.25x of that
    reading's relative L2 (measured 1.03x; the fp32 detector reads 8.6x and
    the port without its bias deltas 1.57x, and the test asserts that both
    fall outside), deltas within 1.5x of its per-conv spread (measured
    0.79x; zero deltas read 3x), and post-NMS set agreement within 0.03 of
    its agreement (JAX against itself reads 0.938-0.955 over six draws, the
    port 0.937).  Set agreement alone cannot hold it at the 0.99 of max
    calibration: the fp32 detector agrees with JAX's int8 one at 0.955 on
    these frames.  ``tools/auto_band_cpu.py`` prints these readings.  On
    JAX's ``quant_state()`` the port is held at >= 0.995.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import pytorch_yolo_tpu as pj
from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu import weights as jw
from pytorch_yolo_tpu.models import darknet as jdn
from pytorch_yolo_tpu.ops import quant as jq
import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import quant as tq
from pytorch_yolo_tpu_torch.utils.drift import detection_drift
from pytorch_yolo_tpu_torch.weights import params_from_jax
from tests.test_new_coords import MINI_CSP_CFG

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = sorted(f[:-4] for f in os.listdir(os.path.join(ROOT, "cfg")) if f.endswith(".cfg"))
FRAMES = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
CALIB = [np.random.default_rng(10 + i).integers(0, 256, (480, 640, 3), dtype=np.uint8)
         for i in range(2)]


def specs(name):
    if name == "mini-csp":
        text = MINI_CSP_CFG
    else:
        with open(os.path.join(ROOT, "cfg", f"{name}.cfg"), encoding="utf-8") as f:
            text = f.read()
    return (jcfg.build_spec(jcfg.parse_cfg_text(text)),
            tcfg.build_spec(tcfg.parse_cfg_text(text)))


def fp_params(jspec, seed=3):
    """The JAX package's folded HWIO params as numpy, and the port's OIHW copy."""
    jp = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=seed))
    jp = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in jp.items()}
    return jp, params_from_jax(jp)


def port_qparams_from_jax(qp):
    """JAX quantized params (HWIO ``wq``) -> the port's layout ((O, kh, kw, I))."""
    out = {}
    for i, p in qp.items():
        if "wq" in p:
            d = {"wq": torch.from_numpy(np.ascontiguousarray(
                     np.asarray(p["wq"]).transpose(3, 0, 1, 2))),
                 "ws": torch.from_numpy(np.asarray(p["ws"], np.float32)),
                 "b": torch.from_numpy(np.asarray(p["b"], np.float32))}
            for k in ("sa", "sag"):
                if k in p:
                    d[k] = torch.from_numpy(np.asarray(p[k], np.float32))
            out[i] = d
        else:
            out[i] = params_from_jax({i: p})[i]
    return out


# ---------------------------------------------------------------------------
# (a) the spec policy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CFGS)
def test_policy_matches_jax(name, monkeypatch):
    jspec, tspec = specs(name)
    assert tq.head_conv_indices(tspec) == jq.head_conv_indices(jspec)
    assert tq._layer_input_strides(tspec) == jq._layer_input_strides(jspec)
    assert tq.conv_input_strides(tspec) == jq.conv_input_strides(jspec)
    assert tq.default_early_min_stride(tspec) == jq.default_early_min_stride(jspec)
    assert tq.concat_split_groups(tspec) == jq.concat_split_groups(jspec)
    for s in (4, 8, 16, 32):
        assert tq.early_skip_profitable(tspec, s) == jq.early_skip_profitable(jspec, s)
        assert tq.early_conv_indices(tspec, s) == jq.early_conv_indices(jspec, s)
    monkeypatch.delenv("PYTORCH_YOLO_INT8_EARLY_STRIDE", raising=False)
    for skip, es, default in (("heads", None, 0), ("heads", None, 8), ((1, 2), 16, 0),
                              ("heads", 0, 8)):
        assert (tq.resolve_skip_layers(tspec, skip, es, default)
                == jq.resolve_skip_layers(jspec, skip, es, default))
    monkeypatch.setenv("PYTORCH_YOLO_INT8_EARLY_STRIDE", "16")
    assert tq.resolve_skip_layers(tspec) == jq.resolve_skip_layers(jspec)


# ---------------------------------------------------------------------------
# (b) quantize_params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scales", ["none", "scalar", "split", "vector"])
def test_quantize_params_matches_jax(scales):
    jspec, tspec = specs("yolov3-tiny")
    jp, tp = fp_params(jspec)
    rng = np.random.default_rng(5)
    groups = jq.concat_split_groups(jspec)
    act = None
    if scales == "scalar":
        act = {i: float(rng.uniform(0.01, 0.1)) for i in jp}
        act[4] = 0.0  # a degenerate scale stays positive (max with the epsilon)
    elif scales == "split":
        act = {i: ([float(v) for v in rng.uniform(0.01, 0.1, len(groups[i]))]
                   if i in groups else float(rng.uniform(0.01, 0.1))) for i in jp}
    elif scales == "vector":
        act = {i: rng.uniform(0.001, 0.1, jp[i]["w"].shape[2]).astype(np.float32) for i in jp}
    ref = jq.quantize_params(jspec, jp, skip_layers="heads", act_scales=act)
    ours = tq.quantize_params(tspec, tp, skip_layers="heads", act_scales=act)
    assert ref.keys() == ours.keys()
    for i, r in ref.items():
        o = ours[i]
        assert sorted(r) == sorted(o), i
        if "wq" not in r:
            np.testing.assert_array_equal(np.asarray(o["w"]),
                                          np.asarray(r["w"]).transpose(3, 2, 0, 1))
            continue
        assert o["wq"].dtype == torch.int8 and o["wq"].is_contiguous()
        np.testing.assert_array_equal(o["wq"].numpy(), np.asarray(r["wq"]).transpose(3, 0, 1, 2))
        for k in ("ws", "b", "sa", "sag"):
            if k in r:
                np.testing.assert_array_equal(o[k].numpy(), np.asarray(r[k]))
    deltas = {i: rng.normal(0, 0.1, np.shape(r["b"])).astype(np.float32)
              for i, r in ref.items() if "wq" in r}
    jd, td = jq.apply_bias_deltas(ref, deltas), tq.apply_bias_deltas(ours, deltas)
    for i in deltas:
        np.testing.assert_array_equal(td[i]["b"].numpy(), np.asarray(jd[i]["b"]))
    with pytest.raises(ValueError, match="bias_delta"):
        tq.apply_bias_deltas(ours, {13: np.zeros(3, np.float32)})


# ---------------------------------------------------------------------------
# (c) K3's plain version against the int8 probe's Pallas GEMM
# ---------------------------------------------------------------------------


def _probe_functions():
    """``epi_intreq``, ``gemm_i8_pallas`` and ``gemm_i8_ref`` as the probe
    wrote them: sliced out of its child-process source and executed."""
    from tools import int8_kernel_probe

    src = int8_kernel_probe.CHILD
    start = src.index("def epi_intreq")
    end = src.index("SHAPES = ")
    start2 = src.index("def _gemm_i8_kernel")
    end2 = src.index("def pallas_selfcheck")
    ns = {"jax": jax, "jnp": jnp, "lax": lax, "pl": pl, "pltpu": pltpu,
          "functools": __import__("functools"), "np": np}
    exec(src[start:end] + src[start2:end2], ns)
    return ns


@pytest.mark.parametrize("m,k,n,pre,mul,sh", [(1024, 256, 128, 10, 181, 8),
                                              (512, 96, 40, 7, 97, 6)])
def test_gemm_i8_plain_matches_probe(m, k, n, pre, mul, sh):
    probe = _probe_functions()
    rng = np.random.default_rng(m + k)
    x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    w = rng.integers(-127, 128, (k, n)).astype(np.int8)
    pallas = np.asarray(probe["gemm_i8_pallas"](jnp.asarray(x), jnp.asarray(w), pre=pre, m=mul,
                                                sh=sh, interpret=True))
    ref = np.asarray(probe["gemm_i8_ref"](jnp.asarray(x), jnp.asarray(w), pre=pre, m=mul, sh=sh))
    ours = tk.int8_gemm(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                        fixed=(pre, mul, sh))
    assert ours.dtype == torch.int8
    np.testing.assert_array_equal(ours.numpy(), pallas)
    np.testing.assert_array_equal(ours.numpy(), ref)
    acc = tk.int8_gemm(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                       accumulators=True)
    np.testing.assert_array_equal(acc.numpy(), x.astype(np.int64) @ w.astype(np.int64))


# ---------------------------------------------------------------------------
# (c2) K3/K4: which core runs a call, and the work a launch does
# ---------------------------------------------------------------------------


# The four yolov3 shapes the card times, batch 128, fp32 out, counted by
# hand: ops = 2 * M * O * KH * KW * C; bytes = input + weights + output.
@pytest.mark.parametrize("x_shape,w_shape,stride,pad,ops,nbytes", [
    # 1x1 52² 256->128: M = 128 * 52 * 52 = 346,112
    ((128, 52, 52, 256), (128, 1, 1, 256), 1, 0, 2 * 346_112 * 128 * 256,
     88_604_672 + 32_768 + 346_112 * 128 * 4),
    # 3x3 s1 52² 128->256
    ((128, 52, 52, 128), (256, 3, 3, 128), 1, 1, 2 * 346_112 * 256 * 1152,
     44_302_336 + 294_912 + 346_112 * 256 * 4),
    # 3x3 s2 104² -> 52², 128->256
    ((128, 104, 104, 128), (256, 3, 3, 128), 2, 1, 2 * 346_112 * 256 * 1152,
     177_209_344 + 294_912 + 346_112 * 256 * 4),
    # 3x3 s1 13² 512->1024: M = 128 * 169 = 21,632
    ((128, 13, 13, 512), (1024, 3, 3, 512), 1, 1, 2 * 21_632 * 1024 * 4608,
     11_075_584 + 4_718_592 + 21_632 * 1024 * 4),
])
def test_igemm_work_counts(x_shape, w_shape, stride, pad, ops, nbytes):
    assert tk.igemm_work(x_shape, w_shape, stride, pad, 4) == (ops, nbytes)
    # the rounded figures the kernel table quotes: 22.7 G / 266 MB, 204 G / 399,
    # 532 and 104 MB
    assert round(ops / 1e9, 1) in (22.7, 204.1)
    assert round(nbytes / 1e6) in (266, 399, 532, 104)
    # int8 and int32 outputs: one byte and four bytes a value
    o_bytes = ops // (2 * w_shape[1] * w_shape[2] * w_shape[3])
    assert tk.igemm_work(x_shape, w_shape, stride, pad, 1)[1] == nbytes - 3 * o_bytes


@pytest.mark.parametrize("c,goff,o,split,aligned,plan", [
    (256, [0, 256], 128, False, True, ("wgmma", 128)),
    (128, [0, 128], 256, False, True, ("wgmma", 256)),
    (512, [0, 512], 1024, False, True, ("wgmma", 256)),
    (64, [0, 64], 16, False, True, ("wgmma", 128)),
    (384, [0, 128, 384], 256, True, True, ("wgmma", 128)),  # split: fp32 group sums
    (256, [0, 80, 256], 128, True, True, ("wgmma", 128)),   # widths not multiples of 128
    (3, [0, 3], 16, False, True, ("mma", 128)),              # the RGB stem: byte path
    (24, [0, 24], 32, False, True, ("mma", 128)),
    (128, [0, 40, 128], 64, True, True, ("mma", 128)),       # a group offset not 16-aligned
    (256, [0, 256], 128, False, False, ("mma", 128)),        # an operand not 16-byte aligned
])
def test_igemm_plan_picks_core_by_shape(c, goff, o, split, aligned, plan):
    assert tk.igemm_plan(c, goff, o, split, aligned) == plan


def test_int8_wrappers_ignore_core_choice_on_cpu():
    """``_mma`` picks a CUDA core; a CPU tensor runs the plain version either way."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-127, 128, (2, 9, 9, 32)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (16, 3, 3, 32)).astype(np.int8))
    before = dict(tk.LAUNCHES)
    for fn, args in ((tk.int8_conv, (x, w, 1, 1)),
                     (tk.int8_gemm, (x.reshape(-1, 32), w[:, 1, 1].contiguous()))):
        np.testing.assert_array_equal(fn(*args, _mma=True, accumulators=True).numpy(),
                                      fn(*args, accumulators=True).numpy())
    assert tk.LAUNCHES == before


# ---------------------------------------------------------------------------
# (d) quantized_conv, one conv per mode
# ---------------------------------------------------------------------------

# name -> (kernel size, stride, activation, mode, out_scale)
CONV_MODES = {
    "1x1_dynamic_leaky": (1, 1, "leaky", "dynamic", None),
    "3x3_dynamic_leaky": (3, 1, "leaky", "dynamic", None),
    "3x3_s2_static_leaky": (3, 2, "leaky", "static", None),
    "1x1_static_mish": (1, 1, "mish", "static", None),
    "3x3_int8_in_linear": (3, 1, "linear", "int8", None),
    "1x1_int8_out_leaky": (1, 1, "leaky", "static", "scalar"),
    "3x3_int8_out_mish_vector": (3, 1, "mish", "static", "vector"),
    "3x3_s2_int8_out_relu": (3, 2, "relu", "dynamic", "scalar"),
    "1x1_split2_leaky": (1, 1, "leaky", "split", None),
    "3x3_split3_int8_out": (3, 1, "leaky", "split3", "scalar"),
    "3x3_vector_sa_logistic": (3, 1, "logistic", "vector", None),
    "1x1_vector_sa_int8_out": (1, 1, "leaky", "vector", "vector"),
}


@pytest.mark.parametrize("name", list(CONV_MODES))
def test_quantized_conv_matches_jax(name):
    k, stride, act, mode, out = CONV_MODES[name]
    c, o = 48, 40
    spec_kw = dict(index=1, in_channels=c, filters=o, size=k, stride=stride, pad=1,
                   batch_normalize=True, activation=act)
    jspec, tspec = jcfg.ConvSpec(**spec_kw), tcfg.ConvSpec(**spec_kw)
    rng = np.random.default_rng(sum(map(ord, name)))
    x = rng.normal(0, 1, (2, 14, 14, c)).astype(np.float32)
    wq = rng.integers(-127, 128, (o, k, k, c)).astype(np.int8)  # the port's layout
    acc_std = np.sqrt(k * k * c) * 35.0 * 73.0
    ws = (rng.uniform(0.5, 1.5, o) * 1.5 / acc_std / 0.03).astype(np.float32)
    b = rng.normal(0, 0.5, o).astype(np.float32)
    kw, splits = {}, None
    if mode in ("static", "int8"):
        kw["sx"] = np.float32(0.03)
    elif mode == "vector":
        kw["sx"] = rng.uniform(0.01, 0.05, c).astype(np.float32)
        ws = ws * np.float32(0.03)
    elif mode.startswith("split"):
        splits = (16, 32) if mode == "split" else (16, 16, 16)
        kw["sxg"] = rng.uniform(0.02, 0.04, len(splits)).astype(np.float32)
    if out == "scalar":
        kw["out_scale"] = np.float32(0.012)
    elif out == "vector":
        kw["out_scale"] = rng.uniform(0.008, 0.016, o).astype(np.float32)
    xin = x
    if mode == "int8":
        xin = np.clip(np.round(x / 0.03), -127, 127).astype(np.int8)
    # compiled, as the JAX Detector runs it: eager ops would not fuse
    conv = jax.jit(lambda xx, ww, s, bb, kk: jq.quantized_conv(xx, ww, s, bb, jspec,
                                                               splits=splits, **kk))
    ref = np.asarray(conv(jnp.asarray(xin), jnp.asarray(wq.transpose(1, 2, 3, 0)),
                          jnp.asarray(ws), jnp.asarray(b),
                          {kk: jnp.asarray(v) for kk, v in kw.items()}))
    ours = tq.quantized_conv(torch.from_numpy(xin), torch.from_numpy(wq), torch.from_numpy(ws),
                             torch.from_numpy(b), tspec, splits=splits,
                             **{kk: torch.as_tensor(v) for kk, v in kw.items()}).numpy()
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    if out is not None:
        assert 0.01 < (np.abs(ref.astype(np.int32)) == 127).mean() < 0.5  # rounds and clips
    if act in ("leaky", "relu", "linear"):
        np.testing.assert_array_equal(ours, ref)
    elif out is None:
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    else:
        d = np.abs(ours.astype(np.int32) - ref.astype(np.int32))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_fma_rounds_once():
    """The plain versions' fused multiply-add rounds once, where a float64
    product-and-sum rounded to fp32 would round twice: (1 + 2^-12)^2 is a
    midpoint between two fp32 values, and 2^-80 decides the side."""
    a = torch.tensor([1 + 2**-12] * 2 + [3.0, -1.5])
    b = torch.tensor([1 + 2**-12] * 2 + [0.1, 7.0])
    c = torch.tensor([2.0**-80, -2.0**-80, 1e-12, 2.0**-60])
    np.testing.assert_array_equal(tk.fma(a, b, c).numpy(),
                                  np.float32([1 + 2**-11 + 2**-23, 1 + 2**-11,
                                              np.float32(3.0) * np.float32(0.1), -10.5]))
    assert float((a[:1].double() * b[:1].double() + c[:1].double()).float()) == 1 + 2**-11


# ---------------------------------------------------------------------------
# (e) int8-resident chains, (f) calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["yolov3-tiny", "yolov3"])
@pytest.mark.parametrize("static", [False, True])
def test_resident_chains_match_jax(name, static):
    jspec, tspec = specs(name)
    jp, tp = fp_params(jspec)
    act = {i: 0.05 for i in jp} if static else None
    skip = jq.resolve_skip_layers(jspec, "heads", default_min_stride=8)
    ref = jq.int8_resident_chains(jspec, jq.quantize_params(jspec, jp, skip, act))
    ours = tq.int8_resident_chains(tspec, tq.quantize_params(tspec, tp, skip, act))
    assert ours == ref
    assert bool(ours) == static


@pytest.mark.parametrize("mode", ["max", "split", "smooth"])
def test_collect_act_scales_matches_jax(mode):
    jspec, tspec = specs("yolov3-tiny")
    jp, tp = fp_params(jspec)
    x = np.random.default_rng(7).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    kw = {"margin": 1.1}
    if mode == "split":
        kw["concat_groups"] = jq.concat_split_groups(jspec)
    elif mode == "smooth":
        kw["smooth_alpha"] = 0.5
    ref = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x, **kw)
    ours = tq.collect_act_scales(tspec, tp, x, device="cpu", **kw)
    assert ours.keys() == ref.keys()
    for i, r in ref.items():
        assert type(ours[i]) is type(r), i
        np.testing.assert_allclose(np.asarray(ours[i]), np.asarray(r),
                                   rtol=1e-4 if mode == "smooth" else 1e-5, atol=0)
    if mode == "split":
        assert any(isinstance(v, list) for v in ours.values())


def test_collect_act_scales_defaults_to_the_card(monkeypatch):
    """Like ``Detector``, calibration runs on the card unless asked for the
    CPU: without CUDA the default raises instead of running on the CPU."""
    jspec, tspec = specs("yolov3-tiny")
    _, tp = fp_params(jspec)
    x = np.random.default_rng(9).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        tq.collect_act_scales(tspec, tp, x)
    scales = tq.collect_act_scales(tspec, tp, x, device="cpu")
    assert scales and all(v > 0 for v in scales.values())


# ---------------------------------------------------------------------------
# (g) the quantized forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["w8a8_dynamic", "w8a8_static_resident", "w8"])
def test_quantized_forward_matches_jax(mode):
    jspec, tspec = specs("yolov3-tiny")
    jp, tp = fp_params(jspec)
    x = np.random.default_rng(8).uniform(0, 1, (2, 160, 160, 3)).astype(np.float32)
    act = None
    if mode == "w8a8_static_resident":
        act = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x)
    quant = "w8" if mode == "w8" else "w8a8"
    qp = jq.quantize_params(jspec, jp, "heads", act)
    ref = jax.jit(jdn.build_forward(jspec, quant=quant))(
        jax.tree_util.tree_map(jnp.asarray, qp), jnp.asarray(x))
    model = tdn.Darknet(tspec, tq.quantize_params(tspec, tp, "heads", act), quant=quant)
    if act is not None:
        assert model._chains == jq.int8_resident_chains(jspec, qp) != {}
    ours = model(torch.from_numpy(x))
    for o, r in zip(ours, ref):
        o, r = o.numpy(), np.asarray(r)
        assert o.shape == r.shape and o.dtype == np.float32
        if quant == "w8":
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4)
        else:
            np.testing.assert_array_equal(o, r)


def test_collect_conv_in_stats_hook():
    """The port's calibration hook sees every conv's input, as JAX's does."""
    jspec, tspec = specs("yolov3-tiny")
    jp, tp = fp_params(jspec)
    x = np.random.default_rng(9).uniform(0, 1, (1, 96, 96, 3)).astype(np.float32)
    stat = lambda i, t: t.shape  # noqa: E731
    _, ref = jdn.build_forward(jspec, collect_conv_in_stats=stat)(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    heads, ours = tdn.Darknet(tspec, tp)(torch.from_numpy(x), collect_conv_in_stats=stat)
    assert len(heads) == 2
    assert {i: tuple(s) for i, s in ours.items()} == {i: tuple(s) for i, s in ref.items()}


# ---------------------------------------------------------------------------
# (h) Detector end to end, (i) the shared quant_state JSON
# ---------------------------------------------------------------------------


def _agree(ref, ours, bound=0.995):
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement >= bound, stats.row()


@pytest.mark.parametrize("static", [False, True])
def test_int8_detector_matches_jax(static):
    cfg = os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")
    kw = {"quant": "w8a8"}
    if static:
        kw.update(quant_calib=CALIB, quant_recipe="none")
    ref = pj.Detector.load(cfg, use_pallas=True, **kw)
    ours = pt.Detector.load(cfg, device="cpu", **kw)
    expected = ref.detect_batch(FRAMES, size=416)
    if not static:
        _agree(expected, ours.detect_batch(FRAMES, size=416))
        return
    assert ours.model._chains and ours.quant_state()["calib_size"] == [416, 416]
    sr, so = ref.quant_state(), ours.quant_state()
    assert so["skip"] == sr["skip"] and so["scales"].keys() == sr["scales"].keys()
    np.testing.assert_allclose([so["scales"][i] for i in so["scales"]],
                               [sr["scales"][i] for i in so["scales"]], rtol=1e-5)
    _agree(expected, ours.detect_batch(FRAMES, size=416), bound=0.99)  # own scales
    _agree(expected, _revive(pt.Detector, sr, device="cpu").detect_batch(FRAMES, size=416))


def _revive(cls, state, **kw):
    return cls.load(os.path.join(ROOT, "cfg", "yolov3-tiny.cfg"), quant="w8a8",
                    quant_act_scales=state["scales"], quant_skip_layers=frozenset(state["skip"]),
                    quant_bias_delta=state.get("bias_delta"), **kw)


def _json(state):
    return json.loads(json.dumps(state))  # through the file format: str keys


@pytest.mark.parametrize("recipe", ["auto", "split"])
def test_jax_quant_state_loads_in_port(recipe):
    """A JAX state with per-channel grids and bias deltas (recipe auto), or
    with per-branch split lists, serves in the port as it does in JAX, and
    the port writes the same state back."""
    cfg = os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")
    kw = ({"quant_recipe": "auto"} if recipe == "auto"
          else {"quant_recipe": "none", "quant_split_concat": True})
    jdet = pj.Detector.load(cfg, quant="w8a8", quant_calib=CALIB, quant_calib_size=256,
                            use_pallas=True, **kw)
    state = _json(jdet.quant_state())
    if recipe == "auto":
        assert state["bias_delta"] and any(isinstance(v, dict) for v in state["scales"].values())
    else:
        assert any(isinstance(v, list) for v in state["scales"].values())
    ours = _revive(pt.Detector, state, device="cpu")
    _agree(jdet.detect_batch(FRAMES, size=256), ours.detect_batch(FRAMES, size=256))
    back = _json(ours.quant_state())
    for key in ("scales", "skip", "bias_delta"):  # recipe/calib_size: provenance stamps
        assert back.get(key) == state.get(key), key


def test_port_quant_state_loads_in_jax():
    cfg = os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")
    ours = pt.Detector.load(cfg, device="cpu", quant="w8a8", quant_calib=CALIB,
                            quant_calib_size=256, quant_recipe="none")
    state = _json(ours.quant_state())
    jdet = _revive(pj.Detector, state, use_pallas=True)
    _agree(jdet.detect_batch(FRAMES, size=256), ours.detect_batch(FRAMES, size=256))
    assert _json(jdet.quant_state())["scales"] == state["scales"]


def test_w8_detector_matches_jax():
    cfg = os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")
    ref = pj.Detector.load(cfg, quant="w8", use_pallas=True)
    ours = pt.Detector.load(cfg, device="cpu", quant="w8")
    assert not ours.model.qconvs and ours.quant_state()["skip"] == sorted(ref._quant_skip)
    _agree(ref.detect_batch(FRAMES, size=256), ours.detect_batch(FRAMES, size=256))


# ---------------------------------------------------------------------------
# (j) the argument checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    ({"quant": "int4"}, "unknown quant mode"),
    ({"quant_calib": CALIB}, "quant is None"),
    ({"quant": "w8", "quant_smooth": 0.5}, "weight-only"),
    ({"quant": "w8a8", "quant_recipe": "fast"}, "unknown quant_recipe"),
    ({"quant": "w8a8", "quant_recipe": "auto"}, "requires quant_calib"),
    ({"quant": "w8a8", "quant_split_concat": True}, "requires quant_calib"),
    ({"quant": "w8a8", "quant_calib": CALIB, "quant_recipe": "none", "quant_smooth": 0.5,
      "quant_split_concat": True}, "mutually exclusive"),
    ({"quant": "w8a8", "quant_calib": CALIB, "quant_recipe": "none",
      "quant_act_scales": {1: 0.1}}, "not both"),
    ({"quant": "w8a8", "quant_calib": CALIB, "quant_recipe": "none",
      "quant_calib_size": 100}, "multiple of 32"),
    ({"quant": "w8a8", "quant_calib": CALIB, "quant_bias_correct": True,
      "quant_recipe": "auto"}, "chooses the int8 knobs"),
    ({"quant": "w8a8", "quant_calib": CALIB, "quant_recipe": "none",
      "quant_calib_percentile": 0.0}, "percentile must be in"),
    ({"quant": "w8a8", "quant_skip_noisy": 2}, "requires quant_calib"),
], ids=["mode", "calib_without_quant", "w8_knob", "recipe", "auto_without_calib",
        "split_without_calib", "smooth_and_split", "calib_and_scales", "calib_size",
        "auto_with_knob", "percentile_range", "skip_noisy_without_calib"])
def test_quant_argument_checks(kw, match):
    with pytest.raises(ValueError, match=match):
        pt.Detector.load("yolov3-tiny", device="cpu", **kw)


def test_partial_act_scales_warn_and_serve_dynamic():
    with pytest.warns(UserWarning, match="fall back to dynamic"):
        det = pt.Detector.load("yolov3-tiny", device="cpu", quant="w8a8",
                               quant_act_scales={"0": 0.01, "2": {"per_channel": [0.1] * 16}})
    assert sorted(det.act_scales()) == [0, 2] and det.model.qconvs["4"].get("sa") is None
    assert len(det.detect_batch(FRAMES[:1], size=128)) == 1


# ---------------------------------------------------------------------------
# (k) the calibration recipe: exact percentiles, bias correction, noise
#     ranking, quant_recipe="auto" and its knobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,q", [(1000, 99.9), (4097, 50.0), (7, 100.0)])
def test_order_statistic_is_exact(n, q):
    """The k-th smallest value, k = ceil(n * (q / 100)) in floats as the
    JAX estimator counts it: at n = 1000, q = 99.9 that is the 1000th
    (99.9 / 100 rounds up), not the 999th."""
    a = np.random.default_rng(n).normal(0, 1, (3, n)).astype(np.float32)
    k = int(np.ceil(n * (q / 100.0)))
    assert n != 1000 or k == 1000
    assert float(tq.order_statistic(torch.from_numpy(a[0]), q)) == np.sort(a[0])[k - 1]
    np.testing.assert_array_equal(tq.order_statistic(torch.from_numpy(a), q, dim=1).numpy(),
                                  np.sort(a, axis=1)[:, k - 1])


def _ratios(ref, ours):
    return np.concatenate([np.atleast_1d(np.asarray(ref[i], np.float64)
                                         / np.asarray(ours[i], np.float64)) for i in ref])


@pytest.mark.parametrize("name,mode", [("yolov3-tiny", "whole"), ("yolov3-tiny", "smooth"),
                                       ("yolov3-tiny", "split"), ("mini-csp", "whole"),
                                       ("mini-csp", "smooth")])
def test_percentile_scales_match_jax(name, mode):
    jspec, tspec = specs(name)
    jp, tp = fp_params(jspec)
    size = 256 if name == "yolov3-tiny" else 64
    x = np.random.default_rng(7).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    kw = {"percentile": 99.9, "margin": 1.1}
    if mode == "smooth":
        kw["smooth_alpha"] = 0.5
    elif mode == "split":
        kw["concat_groups"] = jq.concat_split_groups(jspec)
    ref = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x, **kw)
    ours = tq.collect_act_scales(tspec, tp, x, device="cpu", **kw)
    assert ours.keys() == ref.keys()
    assert all(type(ours[i]) is type(r) for i, r in ref.items())
    r = _ratios(ref, ours)
    assert 1 - 1e-5 <= r.min() and r.max() <= 1.00022, (r.min(), r.max())
    plain = tq.collect_act_scales(tspec, tp, x, device="cpu", margin=1.1)
    if mode == "whole":  # the 99.9th percentile clips: below the max somewhere
        assert all(ours[i] <= plain[i] for i in plain) and any(ours[i] < plain[i] for i in plain)


def _jax_qparams(jspec, jp, x):
    """JAX's own recipe-calibrated quantized params, as the JAX Detector
    makes them, and the port's copy of the same numbers."""
    act = jq.collect_act_scales(jspec, jax.tree_util.tree_map(jnp.asarray, jp), x,
                                percentile=99.9, smooth_alpha=0.5)
    qp = jq.quantize_params(jspec, jp, jq.resolve_skip_layers(jspec, "heads"), act)
    return ({k: {kk: jnp.asarray(vv) for kk, vv in v.items()} for k, v in qp.items()},
            port_qparams_from_jax(qp))


@pytest.mark.parametrize("name", ["yolov3-tiny", "mini-csp"])
def test_bias_correct_matches_jax(name):
    jspec, tspec = specs(name)
    jp, tp = fp_params(jspec)
    size = 256 if name == "yolov3-tiny" else 64
    x = np.random.default_rng(4).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    jqp, tqp = _jax_qparams(jspec, jp, x)
    jout, jd = jq.bias_correct_params(jspec, jax.tree_util.tree_map(jnp.asarray, jp), jqp, x)
    tout, td = tq.bias_correct_params(tspec, tp, tqp, x, device="cpu")
    assert td.keys() == jd.keys() and td
    for i, d in jd.items():
        d = np.asarray(d)
        assert td[i].dtype == np.float32 and td[i].shape == d.shape
        assert np.abs(td[i] - d).max() <= 1e-2 * np.abs(d).max(), i
        np.testing.assert_array_equal(tout[i]["b"].numpy(), tqp[i]["b"].numpy() + td[i])
        assert torch.equal(tout[i]["wq"], tqp[i]["wq"])


@pytest.mark.parametrize("name", ["yolov3-tiny", "mini-csp"])
def test_rank_quant_noise_matches_jax(name):
    jspec, tspec = specs(name)
    jp, tp = fp_params(jspec)
    size = 256 if name == "yolov3-tiny" else 64
    x = np.random.default_rng(5).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    jqp, tqp = _jax_qparams(jspec, jp, x)
    ref = jq.rank_quant_noise(jspec, jax.tree_util.tree_map(jnp.asarray, jp), jqp, x)
    ours = tq.rank_quant_noise(tspec, tp, tqp, x, device="cpu")
    assert len(ours) == len(ref) == sum("wq" in p for p in tqp.values())
    assert [i for i, _ in ours[:4]] == [i for i, _ in ref[:4]]
    r = dict(ref)
    np.testing.assert_allclose([e for _, e in ours], [r[i] for i, _ in ours], rtol=1e-3)


@pytest.mark.parametrize("fn", ["bias_correct_params", "rank_quant_noise"])
def test_recipe_passes_default_to_the_card(fn, monkeypatch):
    jspec, tspec = specs("yolov3-tiny")
    _, tp = fp_params(jspec)
    x = np.random.default_rng(9).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    qp = tq.quantize_params(tspec, tp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        getattr(tq, fn)(tspec, tp, qp, x)
    assert getattr(tq, fn)(tspec, tp, qp, x, device="cpu")


TINY = os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")


AUTO = dict(quant="w8a8", quant_calib=CALIB, quant_calib_size=256, synthetic="live")
HEAD_X = np.random.default_rng(0).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_auto():
    """The JAX package's default int8 calibration (a bare quant_calib) of the
    live-weight yolov3-tiny."""
    return pj.Detector.load(TINY, use_pallas=True, **AUTO)


def _heads(det):
    if isinstance(det, pj.Detector):
        return [np.asarray(h) for h in det._forward(det.params, jnp.asarray(HEAD_X))]
    with torch.no_grad():
        return [h.numpy() for h in det.model(torch.from_numpy(HEAD_X))]


def _rel_l2(heads, ref):
    return float(np.sqrt(sum(((h - r) ** 2).sum() for h, r in zip(heads, ref)))
                 / np.sqrt(sum((r ** 2).sum() for r in ref)))


def _delta_spread(deltas, ref):
    """The largest per-conv max |delta - ref|, relative to the conv's max |ref|."""
    return max(float(np.abs(np.subtract(deltas[i], d)).max() / np.abs(d).max())
               for i, d in ref.items())


def test_auto_detector_matches_jax(jax_auto, monkeypatch):
    """A bare ``quant_calib`` resolves to the recipe in the port too, and
    its state matches JAX's: skip set, recipe stamp, scales within the
    percentile band, a bias delta for every quantized conv.  Its heads,
    deltas and detections are as near JAX's as JAX's own are when its
    scales move inside that band (the bounds and their readings are in the
    module docstring)."""
    ours = pt.Detector.load(TINY, device="cpu", **AUTO)
    sr, so = _json(jax_auto.quant_state()), _json(ours.quant_state())
    assert so["recipe"] == sr["recipe"] == "auto" and so["skip"] == sr["skip"]
    assert so["scales"].keys() == sr["scales"].keys()
    assert all(isinstance(v, dict) for v in so["scales"].values())  # smoothed grids
    r = _ratios({i: v["per_channel"] for i, v in sr["scales"].items()},
                {i: v["per_channel"] for i, v in so["scales"].items()})
    assert 1 - 1e-5 <= r.min() and r.max() <= 1.00022, (r.min(), r.max())
    assert so["bias_delta"].keys() == sr["bias_delta"].keys()

    rng = np.random.default_rng(1)
    collect = jq.collect_act_scales
    monkeypatch.setattr(jq, "collect_act_scales", lambda *a, **k: {
        i: (np.asarray(v, np.float32) / rng.uniform(1, 1.000212, np.shape(v))).astype(np.float32)
        for i, v in collect(*a, **k).items()})
    moved = pj.Detector.load(TINY, use_pallas=True, **AUTO)
    monkeypatch.setattr(jq, "collect_act_scales", collect)

    ref = _heads(jax_auto)
    band = _rel_l2(_heads(moved), ref)
    assert 0 < band and _rel_l2(_heads(ours), ref) <= 1.25 * band
    plain = pt.Detector.load(TINY, device="cpu", synthetic="live")
    undelta = _revive(pt.Detector, dict(so, bias_delta=None), device="cpu", synthetic="live")
    assert _rel_l2(_heads(plain), ref) > 4 * band
    assert _rel_l2(_heads(undelta), ref) > 1.25 * band
    spread = _delta_spread(_json(moved.quant_state())["bias_delta"], sr["bias_delta"])
    assert _delta_spread(so["bias_delta"], sr["bias_delta"]) <= 1.5 * spread < 1.0
    expected = jax_auto.detect_batch(FRAMES, size=256)
    floor = detection_drift(expected, moved.detect_batch(FRAMES, size=256)).set_agreement
    _agree(expected, ours.detect_batch(FRAMES, size=256), bound=floor - 0.03)


def test_port_auto_state_loads_in_jax(jax_auto):
    """The port's recipe state (per-channel grids, bias deltas, the recipe
    stamp) serves in JAX as in the port, and JAX writes it back unchanged."""
    ours = pt.Detector.load(TINY, device="cpu", quant="w8a8", quant_calib=CALIB,
                            quant_calib_size=256, quant_recipe="auto")
    state = _json(ours.quant_state())
    assert state["recipe"] == "auto" and state["bias_delta"]
    jdet = _revive(pj.Detector, state, use_pallas=True)
    _agree(jdet.detect_batch(FRAMES, size=256), ours.detect_batch(FRAMES, size=256))
    back = _json(jdet.quant_state())
    for key in ("scales", "skip", "bias_delta"):
        assert back[key] == state[key], key
    revived = _json(_revive(pt.Detector, _json(jax_auto.quant_state()), device="cpu",
                            synthetic="live").quant_state())
    assert revived["bias_delta"] == _json(jax_auto.quant_state())["bias_delta"]


@pytest.mark.parametrize("knob", ["percentile", "bias_correct", "skip_noisy"])
def test_recipe_knobs_match_jax(knob):
    """Each knob alone (quant_recipe="none"): the port's state matches
    JAX's, and the port serving JAX's state agrees with JAX."""
    kw = {"quant_calib_percentile": 99.9} if knob == "percentile" else (
        {"quant_bias_correct": True} if knob == "bias_correct" else {"quant_skip_noisy": 3})
    kw.update(quant="w8a8", quant_calib=CALIB, quant_calib_size=256, quant_recipe="none")
    jdet = pj.Detector.load(TINY, use_pallas=True, **kw)
    ours = pt.Detector.load(TINY, device="cpu", **kw)
    sr, so = _json(jdet.quant_state()), _json(ours.quant_state())
    assert "recipe" not in so and "recipe" not in sr
    assert so["skip"] == sr["skip"] and so["scales"].keys() == sr["scales"].keys()
    r = _ratios(sr["scales"], so["scales"])
    assert 1 - 1e-5 <= r.min() and r.max() <= (1.00022 if knob == "percentile" else 1 + 1e-5)
    if knob == "skip_noisy":  # three convs beyond the default skip set
        base = pt.Detector.load(TINY, device="cpu", quant="w8a8").quant_state()["skip"]
        assert len(set(so["skip"]) - set(base)) == 3
    assert bool(so.get("bias_delta")) == (knob == "bias_correct")
    for i, d in sr.get("bias_delta", {}).items():
        assert np.abs(np.subtract(so["bias_delta"][i], d)).max() <= 1e-2 * np.abs(d).max(), i
    _agree(jdet.detect_batch(FRAMES, size=256),
           _revive(pt.Detector, sr, device="cpu").detect_batch(FRAMES, size=256))

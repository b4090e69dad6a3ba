"""The port's Darknet forward against the JAX ``build_forward``, head by head.

Both run in fp32 at ``precision="highest"`` on the same numpy params (the
JAX package's ``random_raw_params`` + ``fold_batchnorm``, converted with
``params_from_jax``) and the same numpy input.  Tolerance rtol = atol = 1e-4,
as in ``tests/test_model.py``'s tiny parity test.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu import weights as jw
from pytorch_yolo_tpu.models import darknet as jdn
from pytorch_yolo_tpu.models.zoo import _GENERATORS
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.weights import params_from_jax
from tests.test_new_coords import MINI_CSP_CFG
from tests.torch_threads import one_torch_thread  # noqa: F401

CFGS = {"mini-csp": lambda: MINI_CSP_CFG, **_GENERATORS}


@pytest.mark.parametrize("name,size", [("yolov3-tiny", 160), ("yolov3-tiny", 416),
                                       ("mini-csp", 64), ("yolov2", 160), ("yolov2", 64),
                                       ("yolov2-tiny", 64)])
def test_forward_matches_jax(name, size):
    text = CFGS[name]()
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    params = jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=3))
    x = np.random.default_rng(3).uniform(0, 1, size=(2, size, size, 3)).astype(np.float32)

    ref = jax.jit(jdn.build_forward(jspec))(jax.tree_util.tree_map(jnp.asarray, params),
                                            jnp.asarray(x))
    ours = tdn.Darknet(tspec, params_from_jax(params))(torch.from_numpy(x))
    assert len(ours) == len(ref) == len(tspec.yolo_layers)
    assert tuple(tuple(h.shape) for h in ours) == tdn.head_shapes(tspec, size, 2)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32 and o.is_contiguous()
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("activation", ["leaky", "mish", "relu", "logistic", "linear"])
def test_activation_matches_jax(activation):
    y = np.random.default_rng(0).normal(0, 6, size=4096).astype(np.float32)
    y[:4] = [0.0, -0.0, 80.0, -80.0]  # mish's softplus must not overflow
    ref = np.asarray(jdn.apply_activation(jnp.asarray(y), activation))
    ours = tdn.apply_activation(torch.from_numpy(y.copy()), activation).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["yolov3", "yolov3-tiny", "yolov2", "yolov4-p6"])
def test_head_shapes_match_jax(name):
    text = _GENERATORS[name]()
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    for size in (320, 640, (320, 640)):
        assert tdn.head_shapes(tspec, size, 3) == jdn.head_shapes(jspec, size, 3)


def test_maxpool_and_reorg_match_jax():
    """The Darknet-specific layers alone: (floor, rest) -inf pooling pads
    and the reorg channel shuffle."""
    x = np.random.default_rng(1).normal(size=(2, 12, 12, 8)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for size, stride in ((2, 1), (2, 2), (3, 1), (5, 1)):
        spec = tcfg.MaxPoolSpec(index=0, size=size, stride=stride)
        ref = jdn._maxpool(jnp.asarray(x), jcfg.MaxPoolSpec(index=0, size=size, stride=stride))
        np.testing.assert_array_equal(tdn._maxpool(xt, spec).permute(0, 2, 3, 1).numpy(),
                                      np.asarray(ref))
    np.testing.assert_array_equal(tdn._reorg(xt, 2).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jdn._reorg(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(tdn._upsample(xt, 2).permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jdn._upsample(jnp.asarray(x), 2)))


def test_bfloat16_forward_tracks_fp32():
    """Serving mode: bf16 weights and activations, fp32 heads."""
    text = _GENERATORS["yolov3-tiny"]()
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    params = params_from_jax(jw.fold_batchnorm(jspec, jw.random_raw_params(jspec)))
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (1, 160, 160, 3)).astype(np.float32))
    ref = tdn.Darknet(tspec, params)(x)
    ours = tdn.Darknet(tspec, params, dtype=torch.bfloat16)(x)
    for o, r in zip(ours, ref):
        assert o.dtype == torch.float32
        rel = (o - r).abs() / (r.abs() + 1.0)
        assert float(rel.quantile(0.99)) < 0.1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_native_heads_are_the_head_convs_output(dtype):
    """The serving pipeline's ``_native_heads=True``: the heads in the
    forward's dtype, contiguous NHWC, whose fp32 widening is exactly the
    default fp32 heads (so K1 reads them with no cast pass)."""
    text = _GENERATORS["yolov3-tiny"]()
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    model = tdn.Darknet(tspec, params_from_jax(jw.fold_batchnorm(jspec, jw.random_raw_params(
        jspec))), dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32))
    native, ref = model(x, _native_heads=True), model(x)
    for h, r in zip(native, ref):
        assert h.dtype == dtype and h.is_contiguous() and h.shape == r.shape
        assert r.dtype == torch.float32
        np.testing.assert_array_equal(h.to(torch.float32).numpy(), r.numpy())


def test_native_heads_of_mixed_dtypes_are_fp32():
    """A bf16 W8A8 model whose skip list names one head conv of two: the
    int8 head conv gives fp32 and the skipped one bf16.  K1 reads one dtype
    a launch, so the native heads are widened to fp32, equal to the default
    heads."""
    from pytorch_yolo_tpu_torch.ops import quant as tq

    text = _GENERATORS["yolov3-tiny"]()
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    params = params_from_jax(jw.fold_batchnorm(jspec, jw.random_raw_params(jspec)))
    qp = tq.quantize_params(tspec, params, skip_layers={min(tq.head_conv_indices(tspec))})
    model = tdn.Darknet(tspec, qp, dtype=torch.bfloat16, precision="default", quant="w8a8")
    x = torch.from_numpy(np.random.default_rng(6).uniform(0, 1, (2, 96, 96, 3)).astype(np.float32))
    native, ref = model(x, _native_heads=True), model(x)
    assert [h.dtype for h in native] == [torch.float32] * 2
    for h, r in zip(native, ref):
        assert h.is_contiguous()
        np.testing.assert_array_equal(h.numpy(), r.numpy())


# ---------------------------------------------------------------------------
# The output-stats hook and the space-to-depth stem
# ---------------------------------------------------------------------------


def _pair(name, seed=3):
    text = CFGS[name]()
    jspec = jcfg.build_spec(jcfg.parse_cfg_text(text))
    tspec = tcfg.build_spec(tcfg.parse_cfg_text(text))
    return jspec, tspec, jw.fold_batchnorm(jspec, jw.random_raw_params(jspec, seed=seed))


@pytest.mark.parametrize("name,size", [("yolov3-tiny", 128), ("mini-csp", 64)])
def test_out_stats_hook_matches_jax(name, size):
    """``collect_conv_out_stats`` sees each conv's post-activation output:
    the population stds (the equalizer's statistic) within rtol 1e-4."""
    jspec, tspec, params = _pair(name)
    x = np.random.default_rng(4).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    _, ref = jax.jit(jdn.build_forward(jspec, collect_conv_out_stats=lambda i, t: jnp.std(t)))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    heads, ours = tdn.Darknet(tspec, params_from_jax(params))(
        torch.from_numpy(x), collect_conv_out_stats=lambda i, t: t.std(correction=0))
    assert len(heads) == len(tspec.yolo_layers) and ours.keys() == ref.keys()
    np.testing.assert_allclose([float(ours[i]) for i in ref], [float(ref[i]) for i in ref],
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["yolov3", "yolov3-tiny"])
def test_s2d_packing_matches_jax(name):
    """The packed stem kernels equal JAX's bit for bit after HWIO -> OIHW."""
    jspec, _, params = _pair(name)
    w0, b0 = params[0]["w"], params[0]["b"]
    jw0, jb0 = jdn._pack_s2d_conv0(jnp.asarray(w0), jnp.asarray(b0))
    tw0, tb0 = tdn._pack_s2d_conv0(torch.from_numpy(np.ascontiguousarray(w0.transpose(3, 2, 0, 1))),
                                   torch.from_numpy(b0))
    np.testing.assert_array_equal(tw0.numpy(), np.asarray(jw0).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(tb0.numpy(), np.asarray(jb0))
    if tdn._stem_pattern(tcfg.build_spec(tcfg.parse_cfg_text(CFGS[name]()))) == "conv_conv":
        w1 = params[1]["w"]
        np.testing.assert_array_equal(
            tdn._pack_s2d_conv1(torch.from_numpy(np.ascontiguousarray(w1.transpose(3, 2, 0, 1))))
            .numpy(), np.asarray(jdn._pack_s2d_conv1(jnp.asarray(w1))).transpose(3, 2, 0, 1))
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 3)).astype(np.float32)
    np.testing.assert_array_equal(tdn._space_to_depth(torch.from_numpy(x)).numpy(),
                                  np.asarray(jdn._space_to_depth(jnp.asarray(x))))


@pytest.mark.parametrize("name,n_heads", [("yolov3", 3), ("yolov3-tiny", 2), ("yolov2", 1)])
def test_s2d_stem_exact_f64(name, n_heads):
    """The reparameterization is exact: in float64 the s2d heads equal the
    natural stem's within 1e-8 (``tests/test_stem_s2d.py``'s bound), both
    stem patterns."""
    _, tspec, params = _pair(name, seed=0)
    tp = params_from_jax(params)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 128, 128, 3)))
    base = tdn.Darknet(tspec, tp, dtype=torch.float64)(x)
    s2d = tdn.Darknet(tspec, tp, dtype=torch.float64, stem_s2d=True)(x)
    assert len(base) == len(s2d) == n_heads
    for hb, hs in zip(base, s2d):
        assert hs.dtype == torch.float64
        np.testing.assert_allclose(hs.numpy(), hb.numpy(), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("name", ["yolov3", "yolov3-tiny"])
def test_s2d_stem_boundary_fp32(name):
    """Layer 1's output, the transform's boundary, against the natural
    stem's at fp32 within rtol 1e-4, atol 1e-5 (``tests/test_stem_s2d.py``'s
    bound): the packed conv sums the same products in another order."""
    _, tspec, params = _pair(name, seed=0)
    tp = params_from_jax(params)
    x = torch.from_numpy(np.random.default_rng(0).random((1, 128, 128, 3), dtype=np.float32))
    s2d = tdn.Darknet(tspec, tp, stem_s2d=True)
    with torch.no_grad():
        ours = s2d._s2d_stem(x).permute(0, 2, 3, 1)
    if name == "yolov3":
        _, out = tdn.Darknet(tspec, tp)(x, collect_conv_out_stats=lambda i, t: t.clone()
                                        if i == 1 else None)
        np.testing.assert_allclose(ours.numpy(), out[1].numpy(), rtol=1e-4, atol=1e-5)
    else:
        _, out = tdn.Darknet(tspec, tp)(x, collect_conv_out_stats=lambda i, t: t.clone()
                                        if i == 0 else None)
        pooled = tdn._maxpool(out[0].permute(0, 3, 1, 2), tspec.layers[1]).permute(0, 2, 3, 1)
        np.testing.assert_allclose(ours.numpy(), pooled.numpy(), rtol=1e-4, atol=1e-5)


def test_s2d_heads_match_jax_s2d():
    """fp32 yolov3-tiny with the s2d stem against the JAX s2d forward."""
    jspec, tspec, params = _pair("yolov3-tiny")
    x = np.random.default_rng(3).uniform(0, 1, size=(2, 160, 160, 3)).astype(np.float32)
    ref = jax.jit(jdn.build_forward(jspec, stem_s2d=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    ours = tdn.Darknet(tspec, params_from_jax(params), stem_s2d=True)(torch.from_numpy(x))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-4, atol=1e-4)


def test_s2d_and_hooks_refusals():
    """An inapplicable stem and an int8 stem are refused as in JAX; one
    stats hook at a time; and a stats hook with ``stem_s2d`` raises where
    the JAX forward silently skips convs 0-1 (``darknet.py:434``)."""
    from pytorch_yolo_tpu_torch.ops import quant as tq

    routed = tcfg.build_spec(tcfg.parse_cfg_text(
        "[net]\nwidth=64\nheight=64\nchannels=3\n"
        "[convolutional]\nbatch_normalize=1\nfilters=8\nsize=1\nstride=1\npad=1\nactivation=leaky\n"
        "[maxpool]\nsize=2\nstride=2\n"))
    assert not tdn.stem_s2d_applicable(routed)
    with pytest.raises(ValueError, match="stem pattern"):
        tdn.Darknet(routed, {0: {"w": np.zeros((8, 3, 1, 1), np.float32),
                                 "b": np.zeros(8, np.float32)}}, stem_s2d=True)
    jspec, tspec, params = _pair("yolov3-tiny")
    tp = params_from_jax(params)
    assert tdn._stem_pattern(tspec) == "conv_pool"
    with pytest.raises(ValueError, match="fp stem kernels"):
        tdn.Darknet(tspec, tq.quantize_params(tspec, tp), quant="w8a8", stem_s2d=True)
    x = torch.zeros((1, 64, 64, 3))
    hook = lambda i, t: t.std()  # noqa: E731
    with pytest.raises(ValueError, match="one stats hook"):
        tdn.Darknet(tspec, tp)(x, collect_conv_in_stats=hook, collect_conv_out_stats=hook)
    for kw in ({"collect_conv_in_stats": hook}, {"collect_conv_out_stats": hook}):
        with pytest.raises(ValueError, match="stem_s2d"):
            tdn.Darknet(tspec, tp, stem_s2d=True)(x, **kw)
    # the JAX forward returns stats without convs 0 and 1: the divergence
    _, jstats = jdn.build_forward(jspec, stem_s2d=True, collect_conv_out_stats=hook)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x.numpy()))
    assert 0 not in jstats and 2 in jstats

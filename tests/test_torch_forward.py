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

CFGS = {"mini-csp": lambda: MINI_CSP_CFG, **_GENERATORS}


@pytest.mark.parametrize("name,size", [("yolov3-tiny", 160), ("yolov3-tiny", 416),
                                       ("mini-csp", 64), ("yolov2", 160)])
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

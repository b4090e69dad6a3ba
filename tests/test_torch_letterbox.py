"""The port's letterbox and un-letterbox against the JAX package's, and
against the torch-oracle golden ``tests/goldens/letterbox.npz``.

Tolerance atol = 1e-5 on the [0, 1] canvas (bilinear weights are computed
in a different order by ``jax.image.resize`` and ``F.interpolate``)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pytorch_yolo_tpu.ops import postprocess as jpost
from pytorch_yolo_tpu.ops import preprocess as jpre
from pytorch_yolo_tpu_torch.ops import postprocess as tpost
from pytorch_yolo_tpu_torch.ops import preprocess as tpre
from tests.torch_threads import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "letterbox.npz")


@pytest.mark.parametrize("h0,w0", [(480, 640), (100, 150)], ids=["downscale", "upscale"])
@pytest.mark.parametrize("bgr", [True, False], ids=["bgr", "rgb"])
def test_letterbox_batch_matches_jax(h0, w0, bgr):
    imgs = np.random.default_rng(h0 + bgr).integers(0, 256, size=(2, h0, w0, 3), dtype=np.uint8)
    ref = np.asarray(jpre.letterbox_batch(jnp.asarray(imgs), size=416, bgr=bgr))
    ours = tpre.letterbox_batch(torch.from_numpy(imgs), 416, bgr=bgr)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (2, 416, 416, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_letterbox_matches_golden():
    g = np.load(GOLDEN)
    ours = tpre.letterbox_batch(torch.from_numpy(g["image"][None]), int(g["size"]))
    np.testing.assert_allclose(ours[0].numpy(), g["letterboxed"], rtol=0, atol=1e-5)


def test_letterbox_rectangular_size_matches_jax():
    imgs = np.random.default_rng(7).integers(0, 256, size=(1, 300, 500, 3), dtype=np.uint8)
    ref = np.asarray(jpre.letterbox_batch(jnp.asarray(imgs), size=(320, 416)))
    ours = tpre.letterbox_batch(torch.from_numpy(imgs), (320, 416)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("h0,w0,size", [(480, 640, 416), (100, 150, 416), (67, 101, 128),
                                        (720, 1280, (384, 640)), (640, 480, 608)])
def test_letterbox_geometry_matches_jax(h0, w0, size):
    assert tpre.letterbox_geometry(h0, w0, size) == jpre.letterbox_geometry(h0, w0, size)
    assert tpre.letterbox_geometry(h0, w0, size).out_hw == jpre.letterbox_geometry(h0, w0, size).out_hw


def test_letterbox_rejects_cubic():
    """Cubic is ported now (``tests/test_torch_serving.py`` holds it to the
    JAX resize); a method that is neither linear nor cubic is refused."""
    img = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    assert tuple(tpre.letterbox_batch(img, 32, method="cubic").shape) == (1, 32, 32, 3)
    with pytest.raises(ValueError, match="linear"):
        tpre.letterbox_batch(img, 32, method="nearest")


@pytest.mark.parametrize("h0,w0", [(480, 640), (100, 150)])
def test_unletterbox_matches_jax(h0, w0):
    geo = jpre.letterbox_geometry(h0, w0, 416)
    boxes = np.random.default_rng(w0).uniform(-60, 480, size=(2, 50, 4)).astype(np.float32)
    ref = np.asarray(jpost.unletterbox_boxes(jnp.asarray(boxes), geo))
    ours = tpost.unletterbox_boxes(torch.from_numpy(boxes), tpre.letterbox_geometry(h0, w0, 416))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=1e-5)
    assert ref.min() == 0.0 and ref[..., 2].max() == w0  # clamping exercised


@pytest.mark.parametrize("resize", ["cv2", "numpy"])
@pytest.mark.parametrize("size", [416, (256, 320)], ids=["square", "rect"])
def test_letterbox_host_matches_jax(resize, size, monkeypatch):
    """The calibration canvases equal the JAX package's bit for bit, through
    OpenCV and through the numpy fallback used where ``cv2`` is missing."""
    if resize == "numpy":
        monkeypatch.setitem(__import__("sys").modules, "cv2", None)  # import cv2 -> ImportError
    img = np.random.default_rng(11).integers(0, 256, size=(300, 500, 3), dtype=np.uint8)
    ref, ref_geo = jpre.letterbox_host(img, size)
    ours, geo = tpre.letterbox_host(img, size)
    assert ours.dtype == np.float32 and tuple(geo) == tuple(ref_geo)
    np.testing.assert_array_equal(ours, ref)

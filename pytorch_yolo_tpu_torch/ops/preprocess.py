"""On-device letterbox: uint8 image batch -> network input tensor.

Counterpart of ``pytorch_yolo_tpu/ops/preprocess.py`` (``letterbox_geometry``
and ``letterbox_host`` are copies; ``letterbox_batch`` is the torch version of
the JAX one).
Contract:
  * scale = min(S/W0, S/H0); new sizes truncated toward zero (int()).
  * bilinear resize with half-pixel centres, antialias off, on 0..255 floats.
  * paste centred into an S x S canvas filled with gray 128, divide by 255.
  * output float32 in [0, 1], RGB, NHWC (the JAX package's layout).

Only ``method="linear"`` is ported: torch's ``bicubic`` uses a = -0.75
where ``jax.image.resize`` uses Keys' a = -0.5, so cubic would not match.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class LetterboxGeometry(NamedTuple):
    """Static geometry of a letterbox placement (host-side Python ints/floats)."""

    scale: float
    new_w: int
    new_h: int
    pad_x: int
    pad_y: int
    orig_w: int
    orig_h: int
    size: "int | tuple[int, int]"

    @property
    def out_hw(self) -> tuple[int, int]:
        return _size_hw(self.size)


def _size_hw(size: "int | tuple[int, int]") -> tuple[int, int]:
    """Normalize a network input size: int S -> (S, S); (H, W) passes through."""
    if isinstance(size, tuple):
        return size
    return (size, size)


def letterbox_geometry(orig_h: int, orig_w: int,
                       size: "int | tuple[int, int]") -> LetterboxGeometry:
    """Compute the (static) resize/pad geometry for an (H0, W0) -> (Sh, Sw)
    letterbox.  ``size`` may be a square int or an (H, W) pair (rectangular
    network input)."""
    sh, sw = _size_hw(size)
    scale = min(sw / orig_w, sh / orig_h)
    new_w = int(orig_w * scale)
    new_h = int(orig_h * scale)
    return LetterboxGeometry(
        scale=scale,
        new_w=new_w,
        new_h=new_h,
        pad_x=(sw - new_w) // 2,
        pad_y=(sh - new_h) // 2,
        orig_w=orig_w,
        orig_h=orig_h,
        size=size,
    )


def letterbox_batch(
    imgs: torch.Tensor,
    size: "int | tuple[int, int]",
    bgr: bool = True,
    fill: float = 128.0,
    method: str = "linear",
) -> torch.Tensor:
    """Letterbox a uniform batch (N, H0, W0, 3) uint8 -> (N, Sh, Sw, 3) f32.

    ``bgr=True`` flips the channel order (OpenCV decode convention).  Runs
    on the tensor's own device."""
    if method != "linear":
        raise ValueError(f"only method='linear' is supported, got {method!r}")
    if imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"expected (N, H0, W0, 3) images, got {tuple(imgs.shape)}")
    n, h0, w0, _ = imgs.shape
    geo = letterbox_geometry(h0, w0, size)
    sh, sw = geo.out_hw

    x = imgs.to(torch.float32)
    if bgr:
        x = x.flip(-1)
    resized = F.interpolate(x.permute(0, 3, 1, 2), size=(geo.new_h, geo.new_w),
                            mode="bilinear", align_corners=False, antialias=False)
    canvas = torch.full((n, sh, sw, 3), fill, dtype=torch.float32, device=imgs.device)
    canvas[:, geo.pad_y:geo.pad_y + geo.new_h, geo.pad_x:geo.pad_x + geo.new_w] = (
        resized.permute(0, 2, 3, 1))
    # / 255 as XLA compiles it, a multiply by the fp32 reciprocal, the same
    # bits on every device (ops/quant.py: dynamic_scale)
    return canvas.mul_(1.0 / 255.0)


def letterbox_host(img: np.ndarray, size: "int | tuple[int, int]", bgr: bool = True,
                   fill: float = 128.0) -> tuple[np.ndarray, LetterboxGeometry]:
    """Host-side letterbox: (H0, W0, 3) uint8 -> ((Sh, Sw, 3) f32 [0,1], geometry).

    Copy of ``pytorch_yolo_tpu/ops/preprocess.py: letterbox_host`` for its
    one use here, the int8 calibration canvases (linear, float32 out):
    OpenCV's resize when ``cv2`` is importable, else a numpy half-pixel
    bilinear."""
    h0, w0 = img.shape[:2]
    geo = letterbox_geometry(h0, w0, size)
    sh, sw = geo.out_hw
    x = img.astype(np.float32)
    if bgr:
        x = x[..., ::-1]
    try:
        import cv2

        resized = cv2.resize(x, (geo.new_w, geo.new_h), interpolation=cv2.INTER_LINEAR)
    except ImportError:
        resized = _numpy_bilinear(x, geo.new_h, geo.new_w)
    canvas = np.full((sh, sw, 3), fill, dtype=np.float32)
    canvas[geo.pad_y:geo.pad_y + geo.new_h, geo.pad_x:geo.pad_x + geo.new_w] = resized
    return canvas / 255.0, geo


def _numpy_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Half-pixel-center bilinear resize (float32, no antialias)."""
    in_h, in_w = img.shape[:2]
    sy, sx = in_h / out_h, in_w / out_w
    ys = (np.arange(out_h) + 0.5) * sy - 0.5
    xs = (np.arange(out_w) + 0.5) * sx - 0.5
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    y0c, y1c = np.clip(y0, 0, in_h - 1), np.clip(y0 + 1, 0, in_h - 1)
    x0c, x1c = np.clip(x0, 0, in_w - 1), np.clip(x0 + 1, 0, in_w - 1)
    top = img[y0c][:, x0c] * (1 - wx) + img[y0c][:, x1c] * wx
    bot = img[y1c][:, x0c] * (1 - wx) + img[y1c][:, x1c] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)

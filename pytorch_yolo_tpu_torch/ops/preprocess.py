"""On-device letterbox: uint8 image batch -> network input tensor.

Counterpart of ``pytorch_yolo_tpu/ops/preprocess.py`` (``letterbox_geometry``
and ``letterbox_host`` are copies; ``letterbox_batch`` and ``letterbox_image``
are the torch versions of the JAX ones).
Contract:
  * scale = min(S/W0, S/H0); new sizes truncated toward zero (int()).
  * resize with half-pixel centres, antialias off, on 0..255 floats:
    bilinear (``method="linear"``) or Keys cubic (``"cubic"``, clamped to
    0..255 after the resize).
  * paste centred into an S x S canvas filled with gray 128, divide by 255.
  * output float32 in [0, 1], RGB, NHWC (the JAX package's layout).

Cubic is ``jax.image.resize(method="cubic", antialias=False)``: Keys'
kernel with a = -0.5 and its edge handling (taps outside the image are
dropped and the remaining weights renormalized), applied as one weight
matrix an axis.  torch's ``bicubic`` (a = -0.75, clamped edge taps) is a
different function.  The host letterbox keeps the JAX package's choice:
OpenCV's ``INTER_CUBIC`` where ``cv2`` is importable.
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


def _keys_cubic_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    """(in_size, out_size) fp32 weight matrix of ``jax.image.resize``'s
    cubic resize along one axis (``jax/_src/image/scale.py:
    compute_weight_mat`` with the Keys kernel, a = -0.5, no antialias):
    each output's taps renormalized to sum to 1, an output whose centre
    lies outside the input weighted 0.  The sample position
    ``(i + 0.5) * inv - 0.5`` is one fused multiply-add, as XLA compiles it
    (rounded twice, it moves the weights by up to 2e-5)."""
    from .kernels import fma

    inv = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    a = torch.arange(out_size, dtype=torch.float32) + 0.5
    sample = fma(a, inv.expand_as(a), torch.full_like(a, -0.5))
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    w = ((1.5 * x - 2.5) * x) * x + 1.0
    w = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, w)
    w = torch.where(x >= 2.0, torch.zeros_like(w), w)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _resize_cubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(N, H, W, C) fp32 -> (N, out_h, out_w, C), Keys cubic as
    ``jax.image.resize(method="cubic", antialias=False)``; an axis whose
    size does not change is left as it is, as there."""
    n, h, w, c = x.shape
    if out_h != h:
        x = torch.einsum("nhwc,hk->nkwc", x, _keys_cubic_weights(h, out_h, x.device))
    if out_w != w:
        x = torch.einsum("nhwc,wk->nhkc", x, _keys_cubic_weights(w, out_w, x.device))
    return x


def letterbox_batch(
    imgs: torch.Tensor,
    size: "int | tuple[int, int]",
    bgr: bool = True,
    fill: float = 128.0,
    method: str = "linear",
) -> torch.Tensor:
    """Letterbox a uniform batch (N, H0, W0, 3) uint8 -> (N, Sh, Sw, 3) f32.

    ``bgr=True`` flips the channel order (OpenCV decode convention).
    ``method``: "linear" (bilinear) or "cubic" (Keys, clamped to 0..255).
    Runs on the tensor's own device."""
    if method not in ("linear", "cubic"):
        raise ValueError(f"method must be 'linear' or 'cubic', got {method!r}")
    if imgs.dim() != 4 or imgs.shape[-1] != 3:
        raise ValueError(f"expected (N, H0, W0, 3) images, got {tuple(imgs.shape)}")
    n, h0, w0, _ = imgs.shape
    geo = letterbox_geometry(h0, w0, size)
    sh, sw = geo.out_hw

    x = imgs.to(torch.float32)
    if bgr:
        x = x.flip(-1)
    if method == "cubic":  # bicubic overshoots; the uint8 reference clamps implicitly
        resized = _resize_cubic(x, geo.new_h, geo.new_w).clamp_(0.0, 255.0)
    else:
        resized = F.interpolate(x.permute(0, 3, 1, 2), size=(geo.new_h, geo.new_w),
                                mode="bilinear", align_corners=False,
                                antialias=False).permute(0, 2, 3, 1)
    canvas = torch.full((n, sh, sw, 3), fill, dtype=torch.float32, device=imgs.device)
    canvas[:, geo.pad_y:geo.pad_y + geo.new_h, geo.pad_x:geo.pad_x + geo.new_w] = resized
    # / 255 as XLA compiles it, a multiply by the fp32 reciprocal, the same
    # bits on every device (ops/quant.py: dynamic_scale)
    return canvas.mul_(1.0 / 255.0)


def letterbox_image(img: torch.Tensor, size: "int | tuple[int, int]", bgr: bool = True,
                    fill: float = 128.0, method: str = "linear") -> torch.Tensor:
    """Letterbox one (H0, W0, 3) uint8 image -> (Sh, Sw, 3) float32 in [0, 1]
    (:func:`letterbox_batch` on a batch of one)."""
    return letterbox_batch(img[None], size, bgr=bgr, fill=fill, method=method)[0]


def letterbox_host(img: np.ndarray, size: "int | tuple[int, int]", bgr: bool = True,
                   fill: float = 128.0, method: str = "linear",
                   out_dtype: str = "float32") -> tuple[np.ndarray, LetterboxGeometry]:
    """Host-side letterbox: (H0, W0, 3) uint8 -> ((Sh, Sw, 3) f32 [0,1], geometry).

    Copy of ``pytorch_yolo_tpu/ops/preprocess.py: letterbox_host``: OpenCV's
    resize (``INTER_LINEAR`` or ``INTER_CUBIC``) when ``cv2`` is importable,
    else a numpy half-pixel bilinear (for either method, as there); cubic
    is clamped to 0..255.  ``out_dtype="uint8"`` returns the rounded 0..255
    canvas instead (the /255 then happens on the device, in
    ``Detector.detect_prepared``): a quarter of the bytes to copy."""
    h0, w0 = img.shape[:2]
    geo = letterbox_geometry(h0, w0, size)
    sh, sw = geo.out_hw
    x = img.astype(np.float32)
    if bgr:
        x = x[..., ::-1]
    try:
        import cv2

        interp = cv2.INTER_LINEAR if method == "linear" else cv2.INTER_CUBIC
        resized = cv2.resize(x, (geo.new_w, geo.new_h), interpolation=interp)
    except ImportError:
        resized = _numpy_bilinear(x, geo.new_h, geo.new_w)
    if method == "cubic":
        resized = np.clip(resized, 0.0, 255.0)
    canvas = np.full((sh, sw, 3), fill, dtype=np.float32)
    canvas[geo.pad_y:geo.pad_y + geo.new_h, geo.pad_x:geo.pad_x + geo.new_w] = resized
    if out_dtype == "uint8":
        return np.clip(np.round(canvas), 0, 255).astype(np.uint8), geo
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

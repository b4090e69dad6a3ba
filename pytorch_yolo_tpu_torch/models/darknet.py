"""Darknet forward pass as a ``torch.nn.Module`` built from a ``ModelSpec``.

Counterpart of ``pytorch_yolo_tpu/models/darknet.py: build_forward`` (its
float path).  The public layout is the JAX package's: the input is an NHWC
float batch in [0, 1] and every head comes back as a contiguous fp32
(N, Gy, Gx, A*(5+C)) tensor.  Inside, tensors are NCHW views in
``channels_last`` memory, which is the same NHWC byte order, so the
NHWC <-> NCHW switches at both ends are free and cuDNN runs its NHWC
kernels.

Convolutions stay ``F.conv2d`` (the JAX package left them to XLA too).
BatchNorm arrives folded into the conv (``weights.fold_batchnorm``).

Precision: ``dtype=torch.float32`` with ``precision="highest"`` is the
parity mode — cuDNN's TF32 is switched off for the duration of the forward
only (it is on by default for fp32 convs, the same trap the JAX package
documents for XLA's default precision).  ``dtype=torch.bfloat16`` is the
serving mode: weights and activations in bf16, heads cast to fp32.
"""

from __future__ import annotations

import contextlib
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import (
    ConvSpec,
    MaxPoolSpec,
    ModelSpec,
    RegionSpec,
    ReorgSpec,
    RouteSpec,
    ShortcutSpec,
    UpsampleSpec,
    YoloSpec,
    head_strides,
)


def apply_activation(y: torch.Tensor, activation: str) -> torch.Tensor:
    """Darknet conv activations (leaky slope 0.1; mish with the stable
    softplus ``log1p(exp(-|x|)) + max(x, 0)``; relu; logistic; linear)."""
    if activation == "leaky":  # y > 0 ? y : 0.1f * y, in place on the conv output
        return F.leaky_relu(y, 0.1, inplace=True)
    if activation == "mish":
        sp = torch.log1p(torch.exp(-torch.abs(y))) + torch.clamp(y, min=0.0)
        return y * torch.tanh(sp)
    if activation == "relu":
        return torch.clamp(y, min=0.0)
    if activation == "logistic":
        return torch.sigmoid(y)
    return y  # linear


def _needed_outputs(spec: ModelSpec) -> frozenset[int]:
    """Layer indices whose outputs are consumed by a later route/shortcut."""
    needed: set[int] = set()
    for layer in spec.layers:
        if isinstance(layer, RouteSpec):
            needed.update(layer.layers)
        elif isinstance(layer, ShortcutSpec):
            needed.add(layer.from_layer)
            needed.add(layer.index - 1)
    return frozenset(needed)


def _maxpool(x: torch.Tensor, spec: MaxPoolSpec) -> torch.Tensor:
    """Darknet maxpool: total pad = size-1 split (floor, rest), -inf fill.

    ``F.max_pool2d`` pads symmetrically, so the pad is explicit; this keeps
    the tiny size=2, stride=1 layer at 13x13."""
    total = spec.size - 1
    lo, hi = total // 2, total - total // 2
    if total:
        x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, spec.size, spec.stride).contiguous(memory_format=torch.channels_last)


def _reorg(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Darknet [reorg] on NCHW: (N, C, H, W) -> (N, C*s², H/s, W/s).

    Darknet's channel shuffle, not a plain space-to-depth: the flat NCHW
    buffer is read as (C/s², H*s, W*s) and gathered stride-interleaved
    (``pytorch_yolo_tpu/models/darknet.py: _reorg`` spells out the algebra)."""
    n, c, h, w = x.shape
    s = stride
    six = x.reshape(n, c // (s * s), h, s, w, s)
    out = six.permute(0, 3, 5, 1, 2, 4).reshape(n, c * s * s, h // s, w // s)
    return out.contiguous(memory_format=torch.channels_last)


def _upsample(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer factor, built in NHWC order
    so the result stays ``channels_last``."""
    n, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1)[:, :, None, :, None, :].expand(n, h, stride, w, stride, c)
    return y.reshape(n, h * stride, w * stride, c).permute(0, 3, 1, 2)


@contextlib.contextmanager
def _conv_precision(precision: str):
    """Allow cuDNN TF32 for fp32 convs only when ``precision`` is not
    "highest"; the previous setting is restored on exit."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32
    cudnn.allow_tf32 = precision != "highest"
    try:
        yield
    finally:
        cudnn.allow_tf32 = prev


class Darknet(nn.Module):
    """Darknet network from a :class:`ModelSpec` and folded OIHW params."""

    def __init__(self, spec: ModelSpec, params: "Mapping[int, Mapping[str, np.ndarray]]",
                 dtype: torch.dtype = torch.float32, precision: str = "highest") -> None:
        super().__init__()
        if precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown precision {precision!r}")
        self.spec = spec
        self.dtype = dtype
        self.precision = precision
        self._needed = _needed_outputs(spec)
        self.convs = nn.ModuleDict()
        for layer in spec.layers:
            if not isinstance(layer, ConvSpec):
                continue
            conv = nn.Conv2d(layer.in_channels, layer.filters, layer.size,
                             stride=layer.stride, padding=layer.padding, bias=True)
            w = torch.from_numpy(np.asarray(params[layer.index]["w"], np.float32))
            b = torch.from_numpy(np.asarray(params[layer.index]["b"], np.float32))
            if tuple(w.shape) != tuple(conv.weight.shape):
                raise ValueError(f"layer {layer.index}: weight shape {tuple(w.shape)}, "
                                 f"expected OIHW {tuple(conv.weight.shape)}")
            with torch.no_grad():
                conv.weight.copy_(w)
                conv.bias.copy_(b)
            conv.requires_grad_(False)
            self.convs[str(layer.index)] = conv
        self.to(dtype=dtype, memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """(N, H, W, 3) float in [0, 1] -> raw (N, Gy, Gx, A*(5+C)) fp32 heads."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)  # NHWC bytes, NCHW view
        cache: dict[int, torch.Tensor] = {}
        heads: list[torch.Tensor] = []
        with torch.no_grad(), _conv_precision(self.precision):
            for layer in self.spec.layers:
                if isinstance(layer, ConvSpec):
                    x = apply_activation(self.convs[str(layer.index)](x), layer.activation)
                elif isinstance(layer, MaxPoolSpec):
                    x = _maxpool(x, layer)
                elif isinstance(layer, UpsampleSpec):
                    x = _upsample(x, layer.stride)
                elif isinstance(layer, ReorgSpec):
                    x = _reorg(x, layer.stride)
                elif isinstance(layer, RouteSpec):
                    srcs = [cache[j] for j in layer.layers]
                    if layer.groups > 1:  # CSP split route (YOLOv4-tiny)
                        srcs = [t[:, (t.shape[1] // layer.groups) * layer.group_id:
                                  (t.shape[1] // layer.groups) * (layer.group_id + 1)]
                                for t in srcs]
                    x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
                elif isinstance(layer, ShortcutSpec):
                    x = cache[layer.index - 1] + cache[layer.from_layer]
                elif isinstance(layer, (YoloSpec, RegionSpec)):
                    heads.append(x.permute(0, 2, 3, 1).to(torch.float32).contiguous())
                if layer.index in self._needed:
                    cache[layer.index] = x
        return tuple(heads)


def head_shapes(spec: ModelSpec, input_size: "int | tuple[int, int]",
                batch: int = 1) -> tuple[tuple[int, ...], ...]:
    """Static (N, Gy, Gx, A*(5+C)) shape of each head at a given input size
    (square int or (H, W) pair)."""
    sh, sw = (input_size, input_size) if isinstance(input_size, int) else input_size
    return tuple((batch, sh // stride, sw // stride, len(head.anchors) * (5 + head.classes))
                 for head, stride in zip(spec.yolo_layers, head_strides(spec)))

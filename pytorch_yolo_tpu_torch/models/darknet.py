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

``quant="w8a8"`` runs every conv whose params carry int8 weights (``"wq"``,
from ``ops.quant.quantize_params``) through ``ops.quant.quantized_conv``:
the hand-written int8 kernels K3/K4 on the card, with int8-resident chains
(a producer writes int8 at its consumer's static scale; maxpool and
upsample pass int8 through) and per-branch scales for split-concat convs.
A quantized conv returns fp32, so each fp conv casts its input to the
module's dtype first, as the JAX ``_conv`` does.  ``quant="w8"`` dequantizes
the int8 weights once (``wq * ws``) and runs the fp conv.

Precision: ``dtype=torch.float32`` with ``precision="highest"`` is the
parity mode — cuDNN's TF32 is switched off for the duration of the forward
only (it is on by default for fp32 convs, the same trap the JAX package
documents for XLA's default precision).  ``dtype=torch.bfloat16`` is the
serving mode: weights and activations in bf16, heads cast to fp32 — except
in the serving pipeline, which asks for the heads in the forward's dtype
(``_native_heads=True``) and hands the bf16 views straight to K1, which
widens them in registers (bf16 -> fp32 is exact, so the rows are the same).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Mapping

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
    the tiny size=2, stride=1 layer at 13x13.  An int8-resident input pads
    with -128 instead: max commutes with the monotone quantizer, and a
    window never lies wholly in the padding, so the pad is never chosen.
    ``F.max_pool2d`` has no int8 kernel on CUDA, so int8 takes the max over
    strided window views, which any dtype has."""
    total = spec.size - 1
    lo, hi = total // 2, total - total // 2
    floating = x.is_floating_point()
    if total:
        x = F.pad(x, (lo, hi, lo, hi),
                  value=float("-inf") if floating else torch.iinfo(x.dtype).min)
    if floating:
        y = F.max_pool2d(x, spec.size, spec.stride)
    else:
        y = x.unfold(2, spec.size, spec.stride).unfold(3, spec.size, spec.stride).amax(dim=(4, 5))
    return y.contiguous(memory_format=torch.channels_last)


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


class _QuantConv(nn.Module):
    """The int8 tensors of one W8A8 conv as buffers: ``wq`` (O, kh, kw, I)
    int8, ``ws`` and ``b`` (O,) fp32, and the static ``sa`` or ``sag`` when
    calibrated.  Buffers follow ``.to(device)`` and keep their dtypes."""

    KEYS = ("wq", "ws", "b", "sa", "sag")

    def __init__(self, p: Mapping[str, Any]) -> None:
        super().__init__()
        for k in self.KEYS:
            if k in p:
                self.register_buffer(k, torch.as_tensor(p[k]).clone())

    def get(self, key: str) -> "torch.Tensor | None":
        return getattr(self, key, None)


class Darknet(nn.Module):
    """Darknet network from a :class:`ModelSpec` and folded OIHW params
    (quantized params from ``ops.quant.quantize_params`` with ``quant``)."""

    def __init__(self, spec: ModelSpec, params: "Mapping[int, Mapping[str, Any]]",
                 dtype: torch.dtype = torch.float32, precision: str = "highest",
                 quant: "str | None" = None) -> None:
        super().__init__()
        from ..ops.quant import concat_split_groups, int8_resident_chains

        if precision not in ("highest", "high", "default"):
            raise ValueError(f"unknown precision {precision!r}")
        if quant not in (None, "w8a8", "w8"):
            raise ValueError(f"unsupported quant mode {quant!r}")
        self.spec = spec
        self.dtype = dtype
        self.precision = precision
        self.quant = quant
        self._needed = _needed_outputs(spec)
        self.convs = nn.ModuleDict()
        self.qconvs = nn.ModuleDict()
        for layer in spec.layers:
            if not isinstance(layer, ConvSpec):
                continue
            p = params[layer.index]
            if "wq" in p and quant is None:
                raise ValueError(f"layer {layer.index} has int8 weights: pass quant='w8a8' "
                                 "or 'w8'")
            if "wq" in p and quant == "w8a8":
                self.qconvs[str(layer.index)] = _QuantConv(p)
                continue
            if "wq" in p:  # w8: the int8 kernel dequantized once, then the fp conv
                wq = torch.as_tensor(p["wq"]).permute(0, 3, 1, 2).to(torch.float32)
                w = wq * torch.as_tensor(p["ws"])[:, None, None, None]
            else:
                w = torch.as_tensor(np.asarray(p["w"], np.float32))
            conv = nn.Conv2d(layer.in_channels, layer.filters, layer.size,
                             stride=layer.stride, padding=layer.padding, bias=True)
            b = torch.as_tensor(np.asarray(p["b"], np.float32))
            if tuple(w.shape) != tuple(conv.weight.shape):
                raise ValueError(f"layer {layer.index}: weight shape {tuple(w.shape)}, "
                                 f"expected OIHW {tuple(conv.weight.shape)}")
            with torch.no_grad():
                conv.weight.copy_(w)
                conv.bias.copy_(b)
            conv.requires_grad_(False)
            self.convs[str(layer.index)] = conv
        self.convs.to(dtype=dtype, memory_format=torch.channels_last)
        self._chains = int8_resident_chains(spec, params) if quant == "w8a8" else {}
        self._split_groups = concat_split_groups(spec)

    def _quantized(self, x: torch.Tensor, layer: ConvSpec) -> torch.Tensor:
        """One W8A8 conv on the NCHW (channels_last) view."""
        from ..ops.quant import quantized_conv

        q = self.qconvs[str(layer.index)]
        out_idx = self._chains.get(layer.index)
        y = quantized_conv(
            x.permute(0, 2, 3, 1), q.wq, q.ws, q.b, layer, sx=q.get("sa"),
            out_scale=self.qconvs[str(out_idx)].sa if out_idx is not None else None,
            sxg=q.get("sag"),
            splits=self._split_groups.get(layer.index) if q.get("sag") is not None else None)
        return y.permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor,
                collect_conv_in_stats: "Callable[[int, torch.Tensor], Any] | None" = None,
                _native_heads: bool = False):
        """(N, H, W, 3) float in [0, 1] -> raw (N, Gy, Gx, A*(5+C)) fp32 heads.

        ``collect_conv_in_stats=f`` also returns ``{conv index: f(index,
        conv input as an NHWC view)}`` for every conv where ``f`` returns
        something other than None (the calibration hook).
        ``_native_heads=True`` (the serving pipeline's) returns bf16 and fp32
        heads as they are, the NHWC view of the head conv's ``channels_last``
        output with no copy, when they share one dtype (K1 reads one dtype a
        launch); mixed heads (an int8 head conv gives fp32 beside a skipped
        bf16 one) and other dtypes still become fp32."""
        x = x.permute(0, 3, 1, 2)  # NHWC bytes, NCHW view; each fp conv casts
        cache: dict[int, torch.Tensor] = {}
        heads: list[torch.Tensor] = []
        stats: dict[int, Any] = {}
        with torch.no_grad(), _conv_precision(self.precision):
            for layer in self.spec.layers:
                if isinstance(layer, ConvSpec):
                    if collect_conv_in_stats is not None:
                        s = collect_conv_in_stats(layer.index, x.permute(0, 2, 3, 1))
                        if s is not None:
                            stats[layer.index] = s
                    if str(layer.index) in self.qconvs:
                        x = self._quantized(x, layer)
                    else:
                        conv = self.convs[str(layer.index)]
                        x = apply_activation(conv(x.to(self.dtype)), layer.activation)
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
                    h = x.permute(0, 2, 3, 1)
                    if not (_native_heads and h.dtype in (torch.bfloat16, torch.float32)):
                        h = h.to(torch.float32)
                    heads.append(h.contiguous())
                if layer.index in self._needed:
                    cache[layer.index] = x
        if len({h.dtype for h in heads}) > 1:
            heads = [h.to(torch.float32) for h in heads]
        if collect_conv_in_stats is not None:
            return tuple(heads), stats
        return tuple(heads)


def head_shapes(spec: ModelSpec, input_size: "int | tuple[int, int]",
                batch: int = 1) -> tuple[tuple[int, ...], ...]:
    """Static (N, Gy, Gx, A*(5+C)) shape of each head at a given input size
    (square int or (H, W) pair)."""
    sh, sw = (input_size, input_size) if isinstance(input_size, int) else input_size
    return tuple((batch, sh // stride, sw // stride, len(head.anchors) * (5 + head.classes))
                 for head, stride in zip(spec.yolo_layers, head_strides(spec)))

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

``stem_s2d=True`` runs the space-to-depth stem: the first two layers
(3x3/s1 conv + 3x3/s2 conv, or 3x3/s1 conv + 2x2/s2 maxpool) become one
3x3 conv over the 2x2-block input and a 2x2 stride-1 conv (or a max over
the four phase channel groups).  The kernels are packed once, here at
construction, into OIHW ``nn.Conv2d`` weights (the JAX package packs them
at trace time); the reparameterization is exact up to the order of the
sums.

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


def _stem_pattern(spec: ModelSpec) -> "str | None":
    """Which space-to-depth reparameterization the model's stem admits:
    ``"conv_conv"`` (3x3/s1 conv + 3x3/s2 conv, Darknet-53), ``"conv_pool"``
    (3x3/s1 conv + 2x2/s2 maxpool, the tiny/v2 family), or None (not
    transformable, or layer 0's output is routed to).  A copy of the JAX
    package's rule."""
    layers = spec.layers
    if len(layers) < 2 or 0 in _needed_outputs(spec):
        return None
    l0, l1 = layers[0], layers[1]
    if not (isinstance(l0, ConvSpec) and l0.size == 3 and l0.stride == 1
            and l0.padding == 1 and l0.activation == "leaky"):
        return None
    if (isinstance(l1, ConvSpec) and l1.size == 3 and l1.stride == 2
            and l1.padding == 1 and l1.activation == "leaky"):
        return "conv_conv"
    if isinstance(l1, MaxPoolSpec) and l1.size == 2 and l1.stride == 2:
        return "conv_pool"
    return None


def stem_s2d_applicable(spec: ModelSpec) -> bool:
    """True when ``Darknet(stem_s2d=True)`` can reparameterize the stem."""
    return _stem_pattern(spec) is not None


def _pack_s2d_conv0(w0: torch.Tensor, b0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """OIHW 3x3/s1 conv (O0, C0, 3, 3) -> the 3x3 conv over the space-to-
    depth input, (4*O0, 4*C0, 3, 3), and its bias tiled 4 times.

    Input channel (dy, dx, c) is input pixel (2i+dy, 2j+dx); output channel
    (a, b, o) is output pixel (2i+a, 2j+b), whose tap (r, s) reads block
    i + (a+r-1)//2, phase (a+r-1)%2.  Taps outside the kernel stay exact
    zeros."""
    o0, c0 = w0.shape[0], w0.shape[1]
    pw0 = torch.zeros((4 * o0, 4 * c0, 3, 3), dtype=w0.dtype)
    for a in range(2):
        for b in range(2):
            for r in range(3):
                for s in range(3):
                    di, dy = (a + r - 1) // 2 + 1, (a + r - 1) % 2
                    dj, dx = (b + s - 1) // 2 + 1, (b + s - 1) % 2
                    ci = (dy * 2 + dx) * c0
                    oi = (a * 2 + b) * o0
                    pw0[oi:oi + o0, ci:ci + c0, di, dj] = w0[:, :, r, s]
    return pw0, b0.repeat(4)


def _pack_s2d_conv1(w1: torch.Tensor) -> torch.Tensor:
    """OIHW 3x3/s2 conv (O1, C1, 3, 3) -> the 2x2 stride-1 conv over the
    phase channels of the packed conv0's output, (O1, 4*C1, 2, 2)."""
    o1, c1 = w1.shape[0], w1.shape[1]
    pw1 = torch.zeros((o1, 4 * c1, 2, 2), dtype=w1.dtype)
    for r in range(3):
        for s in range(3):
            di, a = (r - 1) // 2 + 1, (r - 1) % 2
            dj, b = (s - 1) // 2 + 1, (s - 1) % 2
            ci = (a * 2 + b) * c1
            pw1[:, ci:ci + c1, di, dj] = w1[:, :, r, s]
    return pw1


def _space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """NHWC (N, H, W, C) -> (N, H/2, W/2, 4*C), channel order (dy, dx, c)."""
    n, h, w, c = x.shape
    y = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


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
    (quantized params from ``ops.quant.quantize_params`` with ``quant``;
    ``stem_s2d`` runs the space-to-depth stem, whose two convs must keep
    fp kernels)."""

    def __init__(self, spec: ModelSpec, params: "Mapping[int, Mapping[str, Any]]",
                 dtype: torch.dtype = torch.float32, precision: str = "highest",
                 quant: "str | None" = None, stem_s2d: bool = False) -> None:
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
        self.stem_s2d = bool(stem_s2d)
        self._pattern = _stem_pattern(spec) if stem_s2d else None
        if stem_s2d:
            if self._pattern is None:
                raise ValueError("model's first two layers are not a transformable stem pattern "
                                 "(see stem_s2d_applicable / _stem_pattern)")
            stem = [0, 1] if self._pattern == "conv_conv" else [0]
            if any("wq" in params[i] for i in stem):
                raise ValueError("stem_s2d requires fp stem kernels, but the stem convs are "
                                 "int8-quantized — keep layers 0/1 in the quant skip set "
                                 "(default PYTORCH_YOLO_INT8_EARLY_STRIDE=8 does)")
            c0 = self.convs.pop("0")
            pw0, pb0 = _pack_s2d_conv0(c0.weight, c0.bias)
            self.stem0 = self._packed_conv(pw0, pb0, padding=1)
            if self._pattern == "conv_conv":
                c1 = self.convs.pop("1")
                self.stem1 = self._packed_conv(_pack_s2d_conv1(c1.weight), c1.bias, padding=0)
        self.convs.to(dtype=dtype, memory_format=torch.channels_last)
        self._chains = int8_resident_chains(spec, params) if quant == "w8a8" else {}
        self._split_groups = concat_split_groups(spec)

    def _packed_conv(self, w: torch.Tensor, b: torch.Tensor, padding: int) -> nn.Conv2d:
        conv = nn.Conv2d(w.shape[1], w.shape[0], w.shape[2], padding=padding, bias=True)
        with torch.no_grad():
            conv.weight.copy_(w)
            conv.bias.copy_(b)
        conv.requires_grad_(False)
        return conv.to(dtype=self.dtype, memory_format=torch.channels_last)

    def _s2d_stem(self, x: torch.Tensor) -> torch.Tensor:
        """The packed stem on an NHWC batch: layer 1's output as an NCHW
        (``channels_last``) view, as the natural stem gives it."""
        y = _space_to_depth(x).permute(0, 3, 1, 2).to(self.dtype)
        y = apply_activation(self.stem0(y), "leaky")
        if self._pattern == "conv_conv":  # the 3x3/s2 conv: pad (1, 0) on each axis
            return apply_activation(self.stem1(F.pad(y, (1, 0, 1, 0))), "leaky")
        o = y.shape[1] // 4  # 2x2/s2 maxpool: the max over the four phase groups
        return torch.maximum(torch.maximum(y[:, :o], y[:, o:2 * o]),
                             torch.maximum(y[:, 2 * o:3 * o], y[:, 3 * o:]))

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
                collect_conv_out_stats: "Callable[[int, torch.Tensor], Any] | None" = None,
                _native_heads: bool = False):
        """(N, H, W, 3) float in [0, 1] -> raw (N, Gy, Gx, A*(5+C)) fp32
        heads (float64 for a float64 model).

        ``collect_conv_in_stats=f`` also returns ``{conv index: f(index,
        conv input as an NHWC view)}`` for every conv where ``f`` returns
        something other than None (the calibration hook);
        ``collect_conv_out_stats=f`` does the same on each conv's output,
        after its activation (the variance equalizer's hook).  One hook at a
        time, and none with ``stem_s2d``: the packed stem runs no conv 0 or
        1 to show it (the JAX forward skips them silently; the port
        raises).
        ``_native_heads=True`` (the serving pipeline's) returns bf16 and fp32
        heads as they are, the NHWC view of the head conv's ``channels_last``
        output with no copy, when they share one dtype (K1 reads one dtype a
        launch); mixed heads (an int8 head conv gives fp32 beside a skipped
        bf16 one) and other dtypes still become fp32."""
        hooked = collect_conv_in_stats is not None or collect_conv_out_stats is not None
        if collect_conv_in_stats is not None and collect_conv_out_stats is not None:
            raise ValueError("one stats hook at a time: collect_conv_in_stats and "
                             "collect_conv_out_stats share the stats return")
        if hooked and self.stem_s2d:
            raise ValueError("a stats hook with stem_s2d would leave convs 0-1 unseen: the "
                             "packed stem runs neither; build the model with stem_s2d=False")
        cache: dict[int, torch.Tensor] = {}
        heads: list[torch.Tensor] = []
        stats: dict[int, Any] = {}
        layers = self.spec.layers
        with torch.no_grad(), _conv_precision(self.precision):
            if self.stem_s2d:
                x = self._s2d_stem(x)
                if 1 in self._needed:
                    cache[1] = x
                layers = layers[2:]
            else:
                x = x.permute(0, 3, 1, 2)  # NHWC bytes, NCHW view; each fp conv casts
            for layer in layers:
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
                    if collect_conv_out_stats is not None:
                        s = collect_conv_out_stats(layer.index, x.permute(0, 2, 3, 1))
                        if s is not None:
                            stats[layer.index] = s
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
                        h = h.to(torch.promote_types(h.dtype, torch.float32))
                    heads.append(h.contiguous())
                if layer.index in self._needed:
                    cache[layer.index] = x
        if len({h.dtype for h in heads}) > 1:
            heads = [h.to(torch.float32) for h in heads]
        if hooked:
            return tuple(heads), stats
        return tuple(heads)


def head_shapes(spec: ModelSpec, input_size: "int | tuple[int, int]",
                batch: int = 1) -> tuple[tuple[int, ...], ...]:
    """Static (N, Gy, Gx, A*(5+C)) shape of each head at a given input size
    (square int or (H, W) pair)."""
    sh, sw = (input_size, input_size) if isinstance(input_size, int) else input_size
    return tuple((batch, sh // stride, sw // stride, len(head.anchors) * (5 + head.classes))
                 for head, stride in zip(spec.yolo_layers, head_strides(spec)))

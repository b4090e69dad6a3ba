"""W8A8 and W8 int8 quantization of the conv stack.

Counterpart of ``pytorch_yolo_tpu/ops/quant.py``.  The spec policy
(which convs stay fp, which get an early skip, which take per-branch
scales, which chain int8 into the next conv) is plain Python and is a copy
of the JAX package's.  The numbers are the same scheme:

* **Weights**: symmetric per-output-channel int8, ``ws = max|w| / 127``
  over (I, kh, kw) of the BN-folded kernel.  The port holds kernels OIHW;
  ``wq`` is laid out **(O, kh, kw, I)** so the reduction dim is contiguous
  per output channel, the layout the int8 kernels read.
* **Activations**: symmetric per-tensor int8, dynamic (``max|x| / 127``
  on the live tensor, a device scalar) or static (a calibrated ``"sa"``);
  a per-input-channel grid (``quant_smooth``) is folded into the kernels,
  and split-concat convs take one scale per concat branch (``"sag"``).
* **Accumulation** in int32 on the tensor cores, then the fused epilogue
  (dequant, bias, activation, optionally requant to int8 for an
  int8-resident chain) in the kernels of ``ops/kernels.py``: K3
  (``int8_gemm``) for 1x1 stride-1 convs, K4 (``int8_conv``) for the rest.

Calibration (:func:`collect_act_scales`: max or exact-percentile ranging,
split-concat and smoothed grids) and the recipe's two calibration-time
passes (:func:`bias_correct_params`, :func:`rank_quant_noise`) run the
fp32 "highest" forward on the card unless the caller asks for the CPU; the
last two run each quantized conv's int8 twin through K3/K4 there.

The input quantizer stays plain torch (``clamp(round(x / sx), -127, 127)``
in fp32), as the JAX package leaves it to XLA outside any kernel.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Container, Mapping

import numpy as np
import torch

from ..config import (ConvSpec, MaxPoolSpec, ModelSpec, ReorgSpec, RouteSpec,
                      ShortcutSpec, UpsampleSpec, YoloSpec, RegionSpec, head_strides)
from . import kernels

_QEPS = 1e-12  # guards all-zero tensors (sx would otherwise be 0)
_PCT_OCTAVES = 20  # percentile floor: max * 2^-20, the bottom of the JAX estimator's range


# ---------------------------------------------------------------------------
# Spec policy (copies of the JAX package's functions)
# ---------------------------------------------------------------------------


def head_conv_indices(spec: ModelSpec) -> frozenset[int]:
    """Conv layers whose output feeds a detection head directly (the conv
    immediately preceding each ``[yolo]``/``[region]`` block)."""
    head_idx = {l.index for l in spec.layers if isinstance(l, (YoloSpec, RegionSpec))}
    return frozenset(l.index for l in spec.layers
                     if isinstance(l, ConvSpec) and (l.index + 1) in head_idx)


def _layer_input_strides(spec: ModelSpec) -> "dict[int, int]":
    """Per-layer input stride (net-input pixels per feature cell at the
    layer's input) for every layer; routes and shortcuts take their
    source's stride."""
    out_stride: dict[int, int] = {}
    in_stride: dict[int, int] = {}
    cur = 1
    for layer in spec.layers:
        idx = layer.index
        if isinstance(layer, RouteSpec):
            cur = out_stride[layer.layers[0]]
        elif isinstance(layer, ShortcutSpec):
            cur = out_stride[idx - 1]
        in_stride[idx] = cur
        if isinstance(layer, (ConvSpec, MaxPoolSpec, ReorgSpec)):
            cur *= layer.stride
        elif isinstance(layer, UpsampleSpec):
            cur //= layer.stride
        out_stride[idx] = cur
    return in_stride


def conv_input_strides(spec: ModelSpec) -> "dict[int, int]":
    """Per-conv input stride (see :func:`_layer_input_strides`)."""
    in_stride = _layer_input_strides(spec)
    return {l.index: in_stride[l.index] for l in spec.layers if isinstance(l, ConvSpec)}


def early_skip_profitable(spec: ModelSpec, min_stride: int = 8) -> bool:
    """True iff the model has no maxpool in the early (input stride <
    ``min_stride``) region: conv->maxpool->conv ladder families keep their
    int8-resident chains instead of the early skip."""
    in_stride = _layer_input_strides(spec)
    return not any(isinstance(l, MaxPoolSpec) and l.index in in_stride
                   and in_stride[l.index] < min_stride
                   for l in spec.layers)


def default_early_min_stride(spec: ModelSpec) -> int:
    """The JAX package's early-skip stride threshold for this topology:
    0 for ladder families, else 8, 16 when the deepest head stride is 64,
    32 when it is 128.  The thresholds were chosen on a TPU; they are kept
    as the reference's policy until the H100 has its own A/B."""
    if not early_skip_profitable(spec):
        return 0
    deepest = max(head_strides(spec))
    if deepest >= 128:
        return 32
    return 16 if deepest >= 64 else 8


def early_conv_indices(spec: ModelSpec, min_stride: int = 8) -> frozenset[int]:
    """Convs operating on large-spatial tensors (input stride < min_stride)."""
    return frozenset(i for i, s in conv_input_strides(spec).items() if s < min_stride)


def concat_split_groups(spec: ModelSpec) -> "dict[int, tuple[int, ...]]":
    """Convs whose input is a multi-source route concat -> per-source
    channel widths (the concat boundaries)."""
    out: dict[int, tuple[int, ...]] = {}
    for layer in spec.layers:
        if not isinstance(layer, ConvSpec) or layer.index == 0:
            continue
        prev = spec.layers[layer.index - 1]
        if isinstance(prev, RouteSpec) and len(prev.layers) > 1:
            out[layer.index] = tuple(spec.out_channels[j] // prev.groups for j in prev.layers)
    return out


def resolve_skip_layers(spec: ModelSpec, skip_layers: "Container[int] | str" = "heads",
                        early_min_stride: "int | None" = None,
                        default_min_stride: int = 0) -> frozenset[int]:
    """Resolve the ``skip_layers`` token/container into explicit indices and
    union the early-layer skip.  ``early_min_stride=None`` reads
    ``PYTORCH_YOLO_INT8_EARLY_STRIDE`` (the JAX package's override), falling
    back to ``default_min_stride``; ``0`` disables the early skip."""
    if early_min_stride is None:
        early_min_stride = int(os.environ.get("PYTORCH_YOLO_INT8_EARLY_STRIDE",
                                              str(default_min_stride)))
    base = head_conv_indices(spec) if skip_layers == "heads" else frozenset(skip_layers)
    if early_min_stride > 1:
        base = base | early_conv_indices(spec, early_min_stride)
    return base


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def quantize_params(spec: ModelSpec, params: Mapping[int, Mapping[str, np.ndarray]],
                    skip_layers: "Container[int] | str" = "heads",
                    act_scales: "Mapping[int, object] | None" = None) -> dict:
    """BN-folded fp32 OIHW params -> per-layer int8 weights + scales.

    Quantized layers become ``{"wq": (O, kh, kw, I) int8, "ws": (O,) f32,
    "b": (O,) f32}`` torch tensors, plus ``"sa"`` (a 0-d static scale, or an
    (I,) grid already folded into ``wq``) or ``"sag"`` (per-branch scales of
    a split-concat conv) when ``act_scales`` has the layer.  Layers in
    ``skip_layers`` keep ``{"w", "b"}``.  The arithmetic is the JAX
    package's, in fp32, so ``wq`` and ``ws`` equal its own bit for bit."""
    if skip_layers == "heads":
        skip_layers = head_conv_indices(spec)
    out: dict = {}
    for layer in spec.layers:
        if not isinstance(layer, ConvSpec):
            continue
        p = params[layer.index]
        if layer.index in skip_layers or "wq" in p:  # skip or already int8
            out[layer.index] = dict(p)
            continue
        w = torch.as_tensor(np.asarray(p["w"], np.float32))
        sv = act_scales.get(layer.index) if act_scales is not None else None
        vec = isinstance(sv, np.ndarray) and sv.ndim == 1
        if vec:
            # per-channel smoothed grid: fold it into the kernels along C_in,
            # so the dequant needs only ws
            if sv.shape[0] != w.shape[1]:
                raise ValueError(f"conv {layer.index}: per-channel scale vector has "
                                 f"{sv.shape[0]} entries for {w.shape[1]} input channels")
            v = torch.as_tensor(np.maximum(sv, _QEPS).astype(np.float32))
            w = w * v[None, :, None, None]
        ws = w.abs().amax(dim=(1, 2, 3)) / 127.0 + _QEPS  # (O,)
        wq = torch.clamp(torch.round(w / ws[:, None, None, None]), -127, 127).to(torch.int8)
        q = {"wq": wq.permute(0, 2, 3, 1).contiguous(), "ws": ws,
             "b": torch.as_tensor(np.asarray(p["b"], np.float32))}
        if vec:
            q["sa"] = v
        elif act_scales is not None and layer.index in act_scales:
            # max, not +: a zero scale stays positive and save->load->save
            # round trips are idempotent
            sv = act_scales[layer.index]
            if isinstance(sv, (list, tuple)):  # per-branch scales of a route concat
                q["sag"] = torch.tensor([max(float(s), _QEPS) for s in sv], dtype=torch.float32)
            else:
                q["sa"] = torch.tensor(max(float(sv), _QEPS), dtype=torch.float32)
        out[layer.index] = q
    return out


def apply_bias_deltas(qparams: dict, deltas: "Mapping[int, np.ndarray]") -> dict:
    """Re-apply persisted bias-correction deltas to freshly quantized params
    (a scales file's ``bias_delta``)."""
    out = dict(qparams)
    for idx, d in deltas.items():
        q = out.get(idx)
        if q is None or "wq" not in q:
            continue
        d = np.asarray(d, np.float32)
        if d.shape != tuple(q["b"].shape):
            raise ValueError(f"conv {idx}: persisted bias_delta has shape {d.shape} for a "
                             f"({tuple(q['b'].shape)}) bias — scales file does not match "
                             "this model")
        out[idx] = {**q, "b": q["b"] + torch.as_tensor(d)}
    return out


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _calib_device(device: "str | torch.device", what: str) -> torch.device:
    """The calibration device; raises where it is CUDA and CUDA is absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} on {device}, but torch.cuda.is_available() is False: pass "
                           "device='cpu' to calibrate on the CPU")
    return device


def order_statistic(a: torch.Tensor, percentile: float, dim: "int | None" = None) -> torch.Tensor:
    """The exact ``percentile``-th order statistic of ``a`` (all of it, or
    along ``dim``): the k-th smallest value, ``k = ceil(n * q / 100)``
    with ``n * q / 100`` in Python floats, as the JAX estimator counts it.
    ``torch.kthvalue``, not ``torch.quantile``: the latter refuses tensors
    of more than 2^24 elements (yolov3's conv 1 input at 416 with 4 frames
    is 2.2e7)."""
    if dim is None:
        a, dim = a.reshape(-1), 0
    n = a.shape[dim]
    k = max(1, int(math.ceil(n * (percentile / 100.0))))
    return torch.kthvalue(a, k, dim=dim).values


def collect_act_scales(spec: ModelSpec, params: Mapping[int, Mapping[str, np.ndarray]],
                       x: "np.ndarray | torch.Tensor", margin: float = 1.0,
                       percentile: "float | None" = None,
                       concat_groups: "Mapping[int, tuple[int, ...]] | None" = None,
                       smooth_alpha: "float | None" = None,
                       device: "str | torch.device" = "cuda") -> dict:
    """Static activation scales from the fp32 forward on letterboxed
    calibration canvases ``x`` (N, H, W, 3) in [0, 1]: each conv's input
    ``max|x| * margin / 127``, a list of per-branch scales for the convs in
    ``concat_groups``, or with ``smooth_alpha`` a per-input-channel grid
    ``v_c = s_c * sx`` with ``s_c = a_c^alpha / w_c^(1 - alpha)`` for every
    conv.  ``params`` are the fp32 OIHW params; the forward runs at fp32 /
    "highest" on ``device``, the card unless the caller asks for the CPU
    (it raises where CUDA is absent).

    ``percentile=q`` ranges each conv on the q-th percentile of ``|x|``
    over all calibration values instead of the max (and, for the per-channel
    statistics, each channel's over N, H and W): the exact order statistic
    (:func:`order_statistic`), floored at ``max * 2**-20``.  The JAX package
    bisects for it (a TPU compile workaround) and lands within a factor
    2^(20/2^16) above it."""
    from ..models.darknet import Darknet

    device = _calib_device(device, "collect_act_scales")
    if percentile is not None and not 0.0 < percentile <= 100.0:
        raise ValueError(f"percentile must be in (0, 100], got {percentile}")
    if smooth_alpha is not None and concat_groups:
        raise ValueError("smooth_alpha and concat_groups are mutually exclusive "
                         "(per-channel smoothing subsumes per-group split scales)")
    if smooth_alpha is not None and not 0.0 <= smooth_alpha <= 1.0:
        raise ValueError(f"smooth_alpha must be in [0, 1], got {smooth_alpha}")

    per_channel = bool(concat_groups) or smooth_alpha is not None

    def stat(i, t):  # t is the conv input, NHWC
        a = t.abs()
        if percentile is None:
            whole = a.amax(dim=(1, 2, 3))
            return (whole, a.amax(dim=(0, 1, 2))) if per_channel else whole
        floor = 2.0 ** -_PCT_OCTAVES
        whole = torch.maximum(order_statistic(a, percentile),
                              a.amax().clamp_min(_QEPS) * floor)
        if not per_channel:
            return whole
        ac = a.reshape(-1, a.shape[-1]).t()  # (C, N*H*W)
        return whole, torch.maximum(order_statistic(ac, percentile, dim=1),
                                    ac.amax(dim=1).clamp_min(_QEPS) * floor)

    fwd = Darknet(spec, params, dtype=torch.float32, precision="highest").to(device)
    x = torch.as_tensor(np.asarray(x, np.float32)).to(device)
    _, stats = fwd(x, collect_conv_in_stats=stat)
    scales: dict = {}
    for idx, v in stats.items():
        whole = (v[0] if per_channel else v).cpu().numpy()
        if smooth_alpha is not None:
            a_c = np.maximum(v[1].cpu().numpy().astype(np.float32), _QEPS)
            w = np.asarray(params[idx]["w"], np.float32)
            w_c = np.maximum(np.abs(w).max(axis=(0, 2, 3)), _QEPS)
            s_c = a_c ** smooth_alpha / w_c ** (1.0 - smooth_alpha)
            s_c = np.maximum(s_c, _QEPS)
            sx = float((a_c / s_c).max()) * margin / 127.0 + _QEPS
            scales[idx] = (s_c * sx).astype(np.float32)
        elif concat_groups and idx in concat_groups:
            per_ch = v[1].cpu().numpy().astype(np.float32)
            splits = concat_groups[idx]
            if int(per_ch.shape[-1]) != sum(splits):
                raise ValueError(f"conv {idx}: concat split {splits} does not cover its "
                                 f"{per_ch.shape[-1]} input channels")
            gs, off = [], 0
            for c in splits:
                gs.append(float(per_ch[off:off + c].max()) * margin / 127.0 + _QEPS)
                off += c
            scales[idx] = gs
        else:
            scales[idx] = float(np.max(whole)) * margin / 127.0 + _QEPS
    return scales


def _twin_pass(spec: ModelSpec, fp_params, qparams, x, device, linear: bool, reduce) -> dict:
    """One fp32 "highest" forward of ``x`` on ``device`` whose input hook
    runs, for every conv quantized in ``qparams``, the fp conv and its
    quantized twin on the same fp32 input (upstream noise cancels) and
    returns ``reduce(y_fp, y_q)``; ``linear`` runs both twins without their
    activation.  The quantized twin is ``quantized_conv`` without
    ``out_scale``: a K3 or K4 launch with fp32 output on the card."""
    from ..models.darknet import Darknet, apply_activation

    groups = concat_split_groups(spec)
    layers = {l.index: (dataclasses.replace(l, activation="linear") if linear else l)
              for l in spec.layers
              if isinstance(l, ConvSpec) and "wq" in qparams.get(l.index, ())}
    qdev = {i: {k: torch.as_tensor(v).to(device) for k, v in qparams[i].items()}
            for i in layers}
    fwd = Darknet(spec, fp_params, dtype=torch.float32, precision="highest").to(device)

    def hook(idx, t):
        layer = layers.get(idx)
        if layer is None:
            return None
        conv = fwd.convs[str(idx)]
        y_fp = apply_activation(conv(t.permute(0, 3, 1, 2)), layer.activation).permute(0, 2, 3, 1)
        q = qdev[idx]
        y_q = quantized_conv(t, q["wq"], q["ws"], q["b"], layer, sx=q.get("sa"), sxg=q.get("sag"),
                             splits=groups.get(idx) if "sag" in q else None)
        return reduce(y_fp, y_q)

    _, stats = fwd(torch.as_tensor(np.asarray(x, np.float32)).to(device),
                   collect_conv_in_stats=hook)
    return stats


def rank_quant_noise(spec: ModelSpec, fp_params: Mapping[int, Mapping[str, np.ndarray]],
                     qparams: dict, x, device: "str | torch.device" = "cuda"
                     ) -> "list[tuple[int, float]]":
    """Rank the quantized convs by their isolated int8 noise, worst first:
    ``[(conv index, relative L2 error), ...]``.  Each quantized conv (with
    its activation) is compared with the fp32 conv on the same fp32 input
    from a clean fp forward of ``x`` (one or a few letterboxed canvases), so
    only that conv's own error counts; ``||y_q - y_fp|| / ||y_fp||`` (a zero
    denominator counts as 1), ties broken by the lower index.  Feeds
    ``Detector(quant_skip_noisy=K)``.  Runs on ``device``, the card unless
    the caller asks for the CPU."""
    device = _calib_device(device, "rank_quant_noise")

    def reduce(y_fp, y_q):
        d = y_q - y_fp
        return torch.stack([(d * d).sum(), (y_fp * y_fp).sum()])

    stats = _twin_pass(spec, fp_params, qparams, x, device, linear=False, reduce=reduce)
    ranked = []
    for idx, v in stats.items():
        err_sq, ref_sq = v.cpu().tolist()
        ranked.append((idx, math.sqrt(err_sq) / (math.sqrt(ref_sq) or 1.0)))
    ranked.sort(key=lambda t: (-t[1], t[0]))
    return ranked


def bias_correct_params(spec: ModelSpec, fp_params: Mapping[int, Mapping[str, np.ndarray]],
                        qparams: dict, x, device: "str | torch.device" = "cuda"
                        ) -> "tuple[dict, dict[int, np.ndarray]]":
    """Per-output-channel bias correction (DFQ-style): for every quantized
    conv, the mean over N, H and W of ``y_fp - y_q``, both twins run
    ``linear`` (the bias shifts the pre-activation) on the same fp32 input
    of a clean fp forward of ``x``, is added to its bias in fp32.  Returns
    ``(corrected qparams, {conv index: delta})``; the deltas persist as
    ``quant_state()["bias_delta"]``.  Runs on ``device``, the card unless the
    caller asks for the CPU."""
    device = _calib_device(device, "bias_correct_params")
    stats = _twin_pass(spec, fp_params, qparams, x, device, linear=True,
                       reduce=lambda y_fp, y_q: (y_fp - y_q).mean(dim=(0, 1, 2)))
    out = dict(qparams)
    deltas: dict[int, np.ndarray] = {}
    for idx, dv in stats.items():
        d = dv.cpu().numpy().astype(np.float32)
        deltas[idx] = d
        q = qparams[idx]
        out[idx] = {**q, "b": torch.as_tensor(q["b"]) + torch.from_numpy(d)}
    return out, deltas


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def int8_resident_chains(spec: ModelSpec, params: Mapping[int, Mapping]) -> "dict[int, int]":
    """Map producer conv index -> consumer conv index for int8-resident links:
    a quantized conv whose output reaches the next conv only through
    maxpool/upsample layers (int8-transparent), none of them cached for a
    route/shortcut, and whose consumer is quantized with a static ``"sa"``.
    The producer then writes int8 at the consumer's input scale."""
    from ..models.darknet import _needed_outputs

    needed = _needed_outputs(spec)
    layers = spec.layers
    transparent = (MaxPoolSpec, UpsampleSpec)
    chains: dict[int, int] = {}
    for layer in layers:
        if not isinstance(layer, ConvSpec):
            continue
        p = params.get(layer.index)
        if p is None or "wq" not in p or layer.index in needed:
            continue
        k = layer.index + 1
        ok = True
        while ok and k < len(layers) and isinstance(layers[k], transparent):
            if layers[k].index in needed:
                ok = False
            k += 1
        if not (ok and k < len(layers) and isinstance(layers[k], ConvSpec)):
            continue
        pk = params.get(layers[k].index)
        if pk is not None and "wq" in pk and "sa" in pk:
            chains[layer.index] = layers[k].index
    return chains


def dynamic_scale(x: torch.Tensor) -> torch.Tensor:
    """The dynamic input scale ``max|x| / 127 + eps`` as a device scalar,
    computed as the JAX package's compiled program computes it: XLA turns
    the division by a constant into a multiply by its fp32 reciprocal and
    fuses the add into it (one rounding).  Written out, it gives the same
    bits on every device: one bit of difference can flip an int8 rounding
    downstream."""
    m = x.abs().amax()  # fp32 constants filled on the device: no host copy, no sync
    return kernels.fma(m, torch.full_like(m, 1.0 / 127.0), torch.full_like(m, _QEPS))


def quantize_input(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """fp32 ``clamp(round(x / sx), -127, 127)`` as int8; ``sx`` a 0-d scale
    or a per-channel vector over the last (channel) dim."""
    return torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8)


def quantized_conv(x: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor, b: torch.Tensor,
                   spec: ConvSpec, sx: "torch.Tensor | None" = None,
                   out_scale: "torch.Tensor | None" = None,
                   sxg: "torch.Tensor | None" = None,
                   splits: "tuple[int, ...] | None" = None) -> torch.Tensor:
    """One W8A8 conv on an NHWC batch: quantize the input (dynamic
    ``max|x|/127`` when ``sx`` is None, else the static scale; an int8 ``x``
    is taken as already quantized at ``sx``), run the int8 kernel, and
    return NHWC fp32, or int8 at ``out_scale`` (an int8-resident chain).

    ``sxg`` + ``splits`` quantize each concat branch at its own scale; the
    kernel scales each branch's int32 sum by ``sxg[g]`` and adds them in
    fp32.  1x1 stride-1 convs run on K3 (``int8_gemm``), all others on K4
    (``int8_conv``).  All scales stay on the device."""
    epi = dict(ws=ws, b=b, activation=spec.activation, out_scale=out_scale)
    if sxg is not None and splits is not None and x.dtype != torch.int8:
        if sum(splits) != x.shape[-1]:
            raise ValueError(f"concat splits {splits} do not cover the "
                             f"{x.shape[-1]} input channels")
        xf = x.to(torch.float32)
        xq = torch.empty(x.shape, dtype=torch.int8, device=x.device)
        off = 0
        for g, c in enumerate(splits):
            xq[..., off:off + c] = quantize_input(xf[..., off:off + c], sxg[g])
            off += c
        epi.update(sxg=sxg, splits=tuple(splits))
    else:
        if x.dtype == torch.int8:
            if sx is None:
                raise ValueError("int8-resident input requires a static scale")
            xq = x
        else:
            xf = x.to(torch.float32)
            if sx is None:
                sx = dynamic_scale(xf)
            xq = quantize_input(xf, sx)
        epi.update(sx=sx)
    xq = xq.contiguous()
    if spec.size == 1 and spec.stride == 1:
        n, h, w, c = xq.shape
        y = kernels.int8_gemm(xq.reshape(n * h * w, c), wq.reshape(wq.shape[0], c), **epi)
        return y.reshape(n, h, w, -1)
    return kernels.int8_conv(xq, wq, spec.stride, spec.padding, **epi)

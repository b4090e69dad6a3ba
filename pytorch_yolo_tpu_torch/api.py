"""Public detection API: load cfg/weights -> detect -> boxes+scores+classes.

Counterpart of ``pytorch_yolo_tpu/api.py`` on its main path.  One pipeline
per (batch, source shape, size, thresholds) key runs on the detector's
device: letterbox -> Darknet forward -> fused decode+score (K1) -> top-K ->
class-wise NMS keep mask (K2) -> un-letterbox.  The only host<->device
traffic is the uint8 images in and one fixed-shape result out.

``quant="w8a8"`` serves the conv stack in int8 (the int8 kernels K3/K4,
``ops/quant.py``) with dynamic or calibrated static activation scales
(by default the "auto" recipe: percentile ranging, per-channel smoothing
and bias correction); ``quant="w8"`` stores int8 weights and runs fp
convs.  ``stem_s2d`` picks the space-to-depth stem; ``load(...,
synthetic="live")`` gives variance-equalized synthetic weights.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import warnings
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .config import ModelSpec, build_spec, head_strides, parse_cfg_text
from .models.darknet import Darknet
from .ops import quant as q
from .ops.kernels import decode_score_all
from .ops.nms import NMSResult, batched_nms_fused
from .ops.postprocess import unletterbox_boxes
from .ops.preprocess import letterbox_batch, letterbox_geometry, letterbox_host
from .utils.names import load_classes
from .weights import (Params, equalize_raw_params, fold_batchnorm, random_raw_params,
                      read_weights_file)

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfg")


class Detection(NamedTuple):
    """Per-image detection result in original-image pixel coordinates.

    boxes (M, 4) x1,y1,x2,y2 float32; obj (M,); cls_score (M,); cls_id (M,) int32.
    """

    boxes: np.ndarray
    obj: np.ndarray
    cls_score: np.ndarray
    cls_id: np.ndarray

    def __len__(self) -> int:
        return int(self.boxes.shape[0])


def _normalize_channels(images):
    """Coerce the trailing channel axis to 3 (grayscale/BGRA inputs);
    numpy arrays and torch tensors alike."""
    c = images.shape[-1]
    if c == 1:  # grayscale -> replicate channels
        return (np.repeat(images, 3, axis=-1) if isinstance(images, np.ndarray)
                else images.expand(*images.shape[:-1], 3))
    if c == 4:  # BGRA/RGBA -> drop alpha
        return images[..., :3]
    if c != 3:
        raise ValueError(f"expected 1/3/4 channels, got {c}")
    return images


@dataclasses.dataclass(frozen=True)
class _PipelineKey:
    batch: int
    orig_h: int
    orig_w: int
    size: "int | tuple[int, int]"
    conf: float
    iou: float
    max_det: int
    bgr: bool
    score_mode: str = "obj"


def _revive_scale(v):
    """A persisted scale: {"per_channel": [...]} (a smoothed grid), a list
    (per-branch split scales) or a float."""
    if isinstance(v, dict):
        return np.asarray(v["per_channel"], np.float32)
    if isinstance(v, (list, tuple)):
        return [float(s) for s in v]
    return float(v)


class Detector:
    """Loaded YOLO model bound to one torch device for inference.

    ``dtype=torch.float32`` with ``precision="highest"`` is the parity mode
    (no TF32 anywhere); ``dtype=torch.bfloat16`` is the serving mode.  A
    ``device="cuda"`` detector runs the CUDA kernels and raises where CUDA
    is absent; it never falls back to the CPU.

    int8 serving (the ``quant*`` arguments, as in the JAX package):
    ``quant="w8a8"`` quantizes every conv except the head convs (and, with
    bf16 glue, the early large-spatial convs: ``PYTORCH_YOLO_INT8_EARLY_STRIDE``
    overrides) and serves dynamic activation scales, or static ones from
    ``quant_calib`` images or from a persisted ``quant_act_scales`` /
    ``quant_state()``.  A bare ``quant_calib`` means ``quant_recipe="auto"``:
    p99.9 percentile ranging, per-channel smoothing at 0.5 and bias
    correction.  ``quant_recipe="none"`` drives the knobs by hand:
    ``quant_calib_percentile``, ``quant_split_concat`` or ``quant_smooth``,
    ``quant_bias_correct``, and ``quant_skip_noisy=K`` (keep the K convs with
    the largest isolated int8 error in fp).  ``quant="w8"`` is weight-only.
    Calibration runs on the detector's device.

    ``score_mode`` ranks candidates by objectness (``"obj"``) or by
    ``"obj*cls"``.  ``stem_s2d`` runs the space-to-depth stem (an exact
    reparameterization of the first two layers).  The default is off, where the JAX package turns it on for bf16 and int8
    serving of a Darknet-53 stem: on an H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 12,
    bf16 yolov3@416 batch 128) the s2d stem gave 13.3 % less throughput
    (53.279 against 46.214 ms/batch, +15.3 % batch time).
    ``PYTORCH_YOLO_STEM_S2D=1`` turns it on where the stem is conv_conv or
    conv_pool and its convs stay fp; ``=0`` keeps it off."""

    def __init__(
        self,
        spec: ModelSpec,
        params: Params,
        class_names: Sequence[str] | None = None,
        device: "str | torch.device" = "cuda",
        dtype: torch.dtype = torch.float32,
        precision: str = "highest",
        score_mode: str = "obj",
        stem_s2d: "bool | None" = None,
        quant: str | None = None,
        quant_skip_layers: "object" = "heads",
        quant_calib: "Sequence[np.ndarray] | None" = None,
        quant_calib_bgr: bool = True,
        quant_calib_margin: float = 1.0,
        quant_calib_percentile: "float | None" = None,
        quant_calib_size: "int | tuple[int, int] | None" = None,
        quant_skip_noisy: int = 0,
        quant_split_concat: bool = False,
        quant_smooth: "float | None" = None,
        quant_bias_correct: bool = False,
        quant_recipe: "str | None" = None,
        quant_act_scales: "dict | None" = None,
        quant_bias_delta: "dict | None" = None,
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() "
                               "is False")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        if score_mode not in ("obj", "obj*cls"):
            raise ValueError(f"unknown score_mode {score_mode!r} ('obj' or 'obj*cls')")
        self.spec = spec
        self.class_names = tuple(class_names) if class_names else load_classes()
        self.dtype = dtype
        self.precision = precision
        self.score_mode = score_mode
        quant, quant_recipe, quant_calib_percentile, quant_smooth, quant_bias_correct = (
            self._check_quant_args(
                params, quant, quant_calib, quant_calib_percentile, quant_skip_noisy,
                quant_split_concat, quant_smooth, quant_bias_correct, quant_recipe,
                quant_act_scales, quant_bias_delta))
        self.quant = quant
        self._quant_skip: frozenset[int] = frozenset()
        self._bias_deltas: "dict[int, np.ndarray]" = {}
        self._quant_calib_size: "tuple[int, int] | None" = None
        # "none" (the explicit opt-out) persists like no recipe: no stamp
        self._quant_recipe = None if quant_recipe == "none" else quant_recipe
        if quant is not None:
            params = self._quantize(params, quant, quant_skip_layers, quant_calib,
                                    quant_calib_bgr, quant_calib_margin, quant_calib_size,
                                    quant_calib_percentile, quant_skip_noisy, quant_split_concat,
                                    quant_smooth, quant_bias_correct, quant_act_scales,
                                    quant_bias_delta)
        self.stem_s2d = self._resolve_stem_s2d(stem_s2d)
        self.model = Darknet(spec, params, dtype=dtype, precision=precision,
                             quant=quant, stem_s2d=self.stem_s2d).to(self.device)
        self._pipelines: "collections.OrderedDict[_PipelineKey, object]" = (
            collections.OrderedDict())
        self.max_cached_pipelines = 32  # LRU bound for long-running servers

    @staticmethod
    def _check_quant_args(params, quant, quant_calib, quant_calib_percentile, quant_skip_noisy,
                          quant_split_concat, quant_smooth, quant_bias_correct, quant_recipe,
                          quant_act_scales, quant_bias_delta):
        """The JAX Detector's argument checks, in its order; returns the
        resolved quant mode, recipe, and the knobs "auto" sets (p99.9
        percentile, smoothing 0.5, bias correction)."""
        if quant is None and any("wq" in p for p in params.values()):
            quant = "w8a8"  # params arrived pre-quantized
        if quant is None and quant_calib is not None:
            raise ValueError("quant_calib given but quant is None — pass quant='w8a8' to use "
                             "static int8 calibration")
        if quant is None and quant_act_scales is not None:
            raise ValueError("quant_act_scales given but quant is None — pass quant='w8a8' to "
                             "serve persisted scales")
        if quant not in (None, "w8a8", "w8"):
            raise ValueError(f"unknown quant mode {quant!r} (None, 'w8a8', or 'w8')")
        if quant == "w8" and (
                quant_calib is not None or quant_act_scales is not None
                or quant_bias_delta is not None or quant_skip_noisy or quant_split_concat
                or quant_smooth is not None or quant_bias_correct or quant_recipe is not None
                or quant_calib_percentile is not None):
            raise ValueError("quant='w8' is weight-only int8 — activations stay in the "
                             "compute dtype, so there is nothing to calibrate; drop the "
                             "quant_calib/scales/knob arguments (they are w8a8 concepts)")
        if quant_recipe not in (None, "auto", "none"):
            raise ValueError(f"unknown quant_recipe {quant_recipe!r} ('auto' or 'none')")
        explicit = (quant_smooth is not None or quant_bias_correct or quant_split_concat
                    or quant_skip_noisy or quant_calib_percentile is not None)
        if quant_recipe is None and quant_calib is not None and not explicit:
            quant_recipe = "auto"  # the JAX package's calibration default
        if quant_recipe == "auto":
            if quant_calib is None:
                raise ValueError("quant_recipe='auto' requires quant_calib images (the recipe "
                                 "is a calibration policy)")
            if explicit:
                raise ValueError("quant_recipe='auto' chooses the int8 knobs itself — drop "
                                 "the explicit knob arguments (or pass quant_recipe='none')")
            quant_calib_percentile, quant_smooth, quant_bias_correct = 99.9, 0.5, True
        for needed, what in ((quant_skip_noisy, "quant_skip_noisy"),
                             (quant_split_concat, "quant_split_concat"),
                             (quant_smooth is not None, "quant_smooth"),
                             (quant_bias_correct, "quant_bias_correct")):
            if needed and quant_calib is None:
                raise ValueError(f"{what} requires quant_calib images; persisted scale files "
                                 "carry what it computed")
        if quant_smooth is not None and quant_split_concat:
            raise ValueError("quant_smooth and quant_split_concat are mutually exclusive — "
                             "per-channel smoothing subsumes per-branch split scales")
        if quant_bias_delta is not None and quant_calib is not None:
            raise ValueError("pass either quant_calib (fresh calibration) or quant_bias_delta "
                             "(persisted deltas), not both")
        if quant_act_scales is not None and quant_calib is not None:
            raise ValueError("pass either quant_calib (images) or quant_act_scales (persisted "
                             "scales), not both")
        return quant, quant_recipe, quant_calib_percentile, quant_smooth, quant_bias_correct

    def _quantize(self, params, quant, skip_layers, calib, calib_bgr, calib_margin, calib_size,
                  percentile, skip_noisy, split_concat, smooth, bias_correct, act_scales,
                  bias_delta) -> dict:
        """Resolve the skip set, calibrate or revive the static scales,
        widen the skip set by the noisiest convs, quantize, and correct the
        biases (``api.py:237-407`` of the JAX package)."""
        spec = self.spec
        early = (q.default_early_min_stride(spec)
                 if quant == "w8a8" and self.dtype == torch.bfloat16 else 0)
        skip = q.resolve_skip_layers(spec, skip_layers, default_min_stride=early)
        self._quant_skip = skip
        scales = None
        if act_scales is not None:
            scales = {int(k): _revive_scale(v) for k, v in act_scales.items()}
        elif calib is not None:
            if any("wq" in p for p in params.values()):
                raise ValueError("quant_calib requires fp32 params (calibration runs the fp "
                                 "forward); these arrived pre-quantized")
            if calib_size is None:
                size = (spec.net.height, spec.net.width)
            else:
                size = ((calib_size, calib_size) if isinstance(calib_size, int)
                        else (calib_size[0], calib_size[1]))
                mod = max(32, max(head_strides(spec)))
                if any(d % mod for d in size):
                    raise ValueError(f"quant_calib_size {calib_size} must be a multiple of "
                                     f"{mod} (deepest head stride of this model)")
            self._quant_calib_size = size
            canvases = np.stack([letterbox_host(_normalize_channels(im), size,
                                                bgr=calib_bgr)[0] for im in calib])
            groups = ({i: g for i, g in q.concat_split_groups(spec).items() if i not in skip}
                      if split_concat else None)
            scales = q.collect_act_scales(spec, params, canvases, margin=calib_margin,
                                          percentile=percentile, concat_groups=groups,
                                          smooth_alpha=smooth, device=self.device)
            if skip_noisy:  # rank each conv's isolated int8 error on the first canvas
                qtmp = q.quantize_params(spec, params, skip_layers=skip, act_scales=scales)
                ranked = q.rank_quant_noise(spec, params, qtmp, canvases[:1], device=self.device)
                skip = skip | frozenset(i for i, _ in ranked[:skip_noisy])
                self._quant_skip = skip
        fp_params = params
        params = q.quantize_params(spec, params, skip_layers=skip, act_scales=scales)
        if bias_correct:
            params, self._bias_deltas = q.bias_correct_params(spec, fp_params, params,
                                                              canvases[:1], device=self.device)
        elif bias_delta:
            self._bias_deltas = {int(k): np.asarray(v, np.float32) for k, v in bias_delta.items()}
            params = q.apply_bias_deltas(params, self._bias_deltas)
        if act_scales is not None:
            missing = sorted(k for k, p in params.items()
                             if "wq" in p and "sa" not in p and "sag" not in p)
            if missing:
                warnings.warn(
                    f"quant_act_scales covers {len(act_scales)} layers but {len(missing)} "
                    f"quantized convs have no scale (e.g. {missing[:4]}) — they fall back to "
                    "dynamic quantization; re-calibrate under the current skip policy for "
                    "full static int8", stacklevel=3)
        return params

    def _resolve_stem_s2d(self, stem_s2d: "bool | None") -> bool:
        """An explicit ``stem_s2d``, else ``PYTORCH_YOLO_STEM_S2D=1`` where
        the stem can be packed, else off (the H100 A/B in the docstring)."""
        if stem_s2d is not None:
            return bool(stem_s2d)
        if os.environ.get("PYTORCH_YOLO_STEM_S2D") != "1":
            return False
        from .models.darknet import _stem_pattern

        # a quantized stem has no fp kernels to pack
        return (_stem_pattern(self.spec) is not None
                and (self.quant is None or {0, 1} <= self._quant_skip))

    @classmethod
    def load(
        cls,
        cfg: str,
        weights: str | None = None,
        names: str | None = None,
        device: "str | torch.device" = "cuda",
        dtype: torch.dtype = torch.float32,
        precision: str = "highest",
        synthetic: str = "he",
        **kw,
    ) -> "Detector":
        """``cfg`` is a ``.cfg`` path or a model name under ``cfg/``
        ("yolov3", "yolov3-tiny", ...).  With ``weights=None`` the model gets
        synthetic weights, the same numbers as the JAX package's:
        ``synthetic="he"`` is plain He init (deep models saturate their head
        sigmoids), ``"live"`` adds the LSUV variance equalizer
        (``weights.equalize_raw_params``, run on ``device``), which puts the
        head logits in the sigmoid's responsive range.  ``kw`` are the
        constructor's other arguments (``score_mode``, ``stem_s2d``,
        ``quant*``)."""
        path = cfg if cfg.endswith(".cfg") else os.path.join(CFG_DIR, f"{cfg}.cfg")
        with open(path, "r", encoding="utf-8") as f:
            cfg_text = f.read()
        spec = build_spec(parse_cfg_text(cfg_text))
        if weights is not None:
            raw = read_weights_file(spec, weights)
        else:
            if synthetic not in ("he", "live"):
                raise ValueError(f"unknown synthetic regime {synthetic!r} (expected 'he' or "
                                 "'live')")
            raw = random_raw_params(spec)
            if synthetic == "live":
                raw = equalize_raw_params(spec, raw, device=device)
        return cls(spec, fold_batchnorm(spec, raw), class_names=load_classes(names),
                   device=device, dtype=dtype, precision=precision, **kw)

    def act_scales(self) -> "dict[int, float | list[float] | dict]":
        """The static int8 activation scales of the served convs: a float, a
        list of per-branch scales (split concat), or ``{"per_channel": [...]}``
        (a smoothed grid).  JSON-ready; ``quant_act_scales=`` takes it back."""
        out: dict = {}
        for idx, qc in self.model.qconvs.items():
            sa, sag = qc.get("sa"), qc.get("sag")
            if sa is not None:
                sa = sa.cpu()
                out[int(idx)] = (float(sa) if sa.dim() == 0
                                 else {"per_channel": [float(s) for s in sa]})
            elif sag is not None:
                out[int(idx)] = [float(s) for s in sag.cpu()]
        return out

    def quant_state(self) -> dict:
        """JSON-ready static-int8 serving state, the JAX package's format: the
        scales, the resolved skip set, and when present the recipe, the
        calibration size and the bias deltas.  Reload with
        ``load(cfg, quant="w8a8", quant_act_scales=state["scales"],
        quant_skip_layers=frozenset(state["skip"]),
        quant_bias_delta=state.get("bias_delta"))``; a state written by either
        package loads in the other."""
        state = {"version": 1,
                 "scales": {int(i): s for i, s in self.act_scales().items()},
                 "skip": sorted(int(i) for i in self._quant_skip)}
        if self._quant_recipe is not None:
            state["recipe"] = self._quant_recipe
        if self._quant_calib_size is not None:
            state["calib_size"] = list(self._quant_calib_size)
        if self._bias_deltas:
            state["bias_delta"] = {int(i): [float(v) for v in d]
                                   for i, d in self._bias_deltas.items()}
        return state

    # ------------------------------------------------------------------
    # Pipelines (one closure per shape/threshold key)
    # ------------------------------------------------------------------

    def _build_pipeline(self, key: _PipelineKey):
        model, spec = self.model, self.spec
        geo = letterbox_geometry(key.orig_h, key.orig_w, key.size)

        def pipeline(imgs: torch.Tensor) -> NMSResult:
            x = letterbox_batch(imgs, size=key.size, bgr=key.bgr)
            rows = decode_score_all(model(x, _native_heads=True), spec,  # bf16 heads as they are
                                    score_mode=key.score_mode)
            res = batched_nms_fused(rows, conf_thresh=key.conf, iou_thresh=key.iou,
                                    max_det=key.max_det)
            return res._replace(boxes=unletterbox_boxes(res.boxes, geo))

        return pipeline

    def _pipeline(self, key: _PipelineKey):
        fn = self._pipelines.get(key)
        if fn is None:
            fn = self._build_pipeline(key)
            self._pipelines[key] = fn
            while len(self._pipelines) > self.max_cached_pipelines:
                self._pipelines.popitem(last=False)  # evict least-recent
        else:
            self._pipelines.move_to_end(key)
        return fn

    def _resolve_size(self, size: "int | tuple[int, int] | None"):
        """Default to the cfg's [net] size; a square int or an (H, W) pair,
        a multiple of the deepest head stride (at least 32)."""
        if size is None:
            h, w = self.spec.net.height, self.spec.net.width
            size = w if h == w else (h, w)
        mod = max(32, max(head_strides(self.spec)))
        for d in (size if isinstance(size, tuple) else (size,)):
            if d % mod:
                raise ValueError(f"input size {size} must be a multiple of {mod} "
                                 "(deepest head stride of this model)")
        return size

    def _to_device(self, images) -> torch.Tensor:
        if images.ndim != 4:
            raise ValueError(f"expected (N, H, W, C) uint8 batch, got {tuple(images.shape)}")
        images = _normalize_channels(images)
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return images.to(self.device).contiguous()

    # ------------------------------------------------------------------
    # Detection entry points
    # ------------------------------------------------------------------

    def detect(self, image, size: "int | tuple[int, int] | None" = None, conf: float = 0.5,
               iou: float = 0.4, max_det: int = 300, bgr: bool = True) -> Detection:
        """Detect objects in one (H, W, 3) uint8 image."""
        return self.detect_batch(image[None], size, conf, iou, max_det, bgr)[0]

    def detect_batch(self, images, size: "int | tuple[int, int] | None" = None,
                     conf: float = 0.5, iou: float = 0.4, max_det: int = 300,
                     bgr: bool = True) -> list[Detection]:
        """Detect objects in a uniform (N, H, W, 3) uint8 batch (numpy array
        or torch tensor on any device)."""
        res = self.raw_result(images, size, conf, iou, max_det, bgr)
        return self._trim(res, res.valid.shape[0])

    def raw_result(self, images, size: "int | tuple[int, int] | None" = None,
                   conf: float = 0.5, iou: float = 0.4, max_det: int = 300,
                   bgr: bool = True) -> NMSResult:
        """Device-resident fixed-shape result (no host trim) — for pipelining."""
        imgs = self._to_device(images)
        key = _PipelineKey(batch=imgs.shape[0], orig_h=imgs.shape[1], orig_w=imgs.shape[2],
                           size=self._resolve_size(size), conf=conf, iou=iou,
                           max_det=max_det, bgr=bgr, score_mode=self.score_mode)
        return self._pipeline(key)(imgs)

    @staticmethod
    def _trim(res: NMSResult, n: int) -> list[Detection]:
        """One D2H copy of the packed result, then trim each image's valid
        rows on the host."""
        packed = torch.cat([res.boxes, res.obj[..., None], res.cls_score[..., None],
                            res.cls_id[..., None].to(torch.float32),
                            res.valid[..., None].to(torch.float32)], dim=-1)
        host = packed.cpu().numpy()
        out = []
        for i in range(n):
            m = host[i, :, 7] > 0.5
            out.append(Detection(boxes=host[i, m, 0:4], obj=host[i, m, 4],
                                 cls_score=host[i, m, 5],
                                 cls_id=host[i, m, 6].astype(np.int32)))
        return out


def load(cfg: str, weights: str | None = None, **kw) -> Detector:
    """Module-level convenience mirroring the reference's ``load`` API."""
    return Detector.load(cfg, weights, **kw)


def detect(model: Detector, image, conf: float = 0.5, nms: float = 0.4,
           size: int | None = None, **kw) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference-shaped free function: returns (boxes, scores, classes),
    ``scores`` being the objectness column."""
    d = model.detect(image, size=size, conf=conf, iou=nms, **kw)
    return d.boxes, d.obj, d.cls_id

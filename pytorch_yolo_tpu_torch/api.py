"""Public detection API: load cfg/weights -> detect -> boxes+scores+classes.

Counterpart of ``pytorch_yolo_tpu/api.py`` on its main path.  One pipeline
per (batch, source shape, size, thresholds) key runs on the detector's
device: letterbox -> Darknet forward -> fused decode+score (K1) -> top-K ->
class-wise NMS keep mask (K2) -> un-letterbox.  The only host<->device
traffic is the uint8 images in and one fixed-shape result out.
"""

from __future__ import annotations

import collections
import dataclasses
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from .config import ModelSpec, build_spec, head_strides, parse_cfg_text
from .models.darknet import Darknet
from .ops.kernels import decode_score_all
from .ops.nms import NMSResult, batched_nms_fused
from .ops.postprocess import unletterbox_boxes
from .ops.preprocess import letterbox_batch, letterbox_geometry
from .utils.names import load_classes
from .weights import Params, fold_batchnorm, random_raw_params, read_weights_file

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


class Detector:
    """Loaded YOLO model bound to one torch device for inference.

    ``dtype=torch.float32`` with ``precision="highest"`` is the parity mode
    (no TF32 anywhere); ``dtype=torch.bfloat16`` is the serving mode.  A
    ``device="cuda"`` detector runs the CUDA kernels and raises where CUDA
    is absent; it never falls back to the CPU."""

    def __init__(
        self,
        spec: ModelSpec,
        params: Params,
        class_names: Sequence[str] | None = None,
        device: "str | torch.device" = "cuda",
        dtype: torch.dtype = torch.float32,
        precision: str = "highest",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() "
                               "is False")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.spec = spec
        self.class_names = tuple(class_names) if class_names else load_classes()
        self.dtype = dtype
        self.precision = precision
        self.model = Darknet(spec, params, dtype=dtype, precision=precision).to(self.device)
        self._pipelines: "collections.OrderedDict[_PipelineKey, object]" = (
            collections.OrderedDict())
        self.max_cached_pipelines = 32  # LRU bound for long-running servers

    @classmethod
    def load(
        cls,
        cfg: str,
        weights: str | None = None,
        names: str | None = None,
        device: "str | torch.device" = "cuda",
        dtype: torch.dtype = torch.float32,
        precision: str = "highest",
    ) -> "Detector":
        """``cfg`` is a ``.cfg`` path or a model name under ``cfg/``
        ("yolov3", "yolov3-tiny", ...).  With ``weights=None`` the model gets
        synthetic He-init weights, the same numbers as the JAX package's
        default ``synthetic="he"``."""
        path = cfg if cfg.endswith(".cfg") else os.path.join(CFG_DIR, f"{cfg}.cfg")
        with open(path, "r", encoding="utf-8") as f:
            cfg_text = f.read()
        spec = build_spec(parse_cfg_text(cfg_text))
        raw = read_weights_file(spec, weights) if weights is not None else random_raw_params(spec)
        return cls(spec, fold_batchnorm(spec, raw), class_names=load_classes(names),
                   device=device, dtype=dtype, precision=precision)

    # ------------------------------------------------------------------
    # Pipelines (one closure per shape/threshold key)
    # ------------------------------------------------------------------

    def _build_pipeline(self, key: _PipelineKey):
        model, spec = self.model, self.spec
        geo = letterbox_geometry(key.orig_h, key.orig_w, key.size)

        def pipeline(imgs: torch.Tensor) -> NMSResult:
            x = letterbox_batch(imgs, size=key.size, bgr=key.bgr)
            rows = decode_score_all(model(x), spec)
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
                           max_det=max_det, bgr=bgr)
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

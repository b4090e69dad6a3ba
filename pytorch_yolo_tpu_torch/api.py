"""Public detection API: load cfg/weights -> detect -> boxes+scores+classes.

Counterpart of ``pytorch_yolo_tpu/api.py``.  One pipeline per (batch,
source shape, size, thresholds) key runs on the detector's device:
letterbox -> Darknet forward -> fused decode+score (K1) -> top-K ->
class-wise NMS keep mask (K2) -> un-letterbox.  The only host<->device
traffic is the uint8 images in and one fixed-shape result out.

The prepared pipeline (one a batch size, whatever the source shapes) takes
host-letterboxed canvases, f32 or uint8, with one geometry row an image:
``detect_prepared``, and on it ``detect_many`` (chunks of mixed sizes,
the host letterbox of chunk t+1 overlapping the device work of chunk t)
and ``detect_stream(host_preproc=True)``.  On the card the canvases go
through pinned staging buffers with ``non_blocking`` copies.

``quant="w8a8"`` serves the conv stack in int8 (the int8 kernels K3/K4,
``ops/quant.py``) with dynamic or calibrated static activation scales
(by default the "auto" recipe: percentile ranging, per-channel smoothing
and bias correction); ``quant="w8"`` stores int8 weights and runs fp
convs.  ``stem_s2d`` picks the space-to-depth stem; ``load(...,
synthetic="live")`` gives variance-equalized synthetic weights.

``mesh=`` (``parallel.sharding.make_batch_mesh``) splits every batch over
the mesh's devices, as the JAX package's batch mesh does: one model replica
a device, shard i of the batch through the pipeline on entry i's device,
the dynamic int8 scale taken over the whole batch, the fixed-shape results
gathered on the first device.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
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
from .ops.postprocess import unletterbox_boxes, unletterbox_boxes_dynamic
from .ops.preprocess import letterbox_batch, letterbox_geometry, letterbox_host
from .parallel.sharding import (BatchMesh, gather_batch, pad_to_multiple, replicate_params,
                                shard_batch)
from .utils.names import load_classes
from .weights import (Params, equalize_raw_params, fold_batchnorm, load_weights,
                      random_raw_params)

log = logging.getLogger(__name__)

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


def _transfer_dtype(transfer: str) -> str:
    """Host-path copy mode: "f32" normalized floats, "u8" rounded bytes."""
    try:
        return {"f32": "float32", "u8": "uint8"}[transfer]
    except KeyError:
        raise ValueError(f"transfer must be 'f32' or 'u8', got {transfer!r}") from None


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
    orig_h: int  # 0 for prepared-input pipelines (host letterbox)
    orig_w: int
    size: "int | tuple[int, int]"
    conf: float
    iou: float
    max_det: int
    bgr: bool
    score_mode: str = "obj"
    prepared: bool = False

_IDENTITY_GEO = (1.0, 0.0, 0.0, 1.0, 1.0)  # the geometry row of a padding frame


def _pad_rows(x, k: int):
    """``x`` (numpy array or tensor) with ``k`` zero rows appended."""
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.zeros((k,) + x.shape[1:], x.dtype)])
    return torch.cat([x, x.new_zeros((k,) + tuple(x.shape[1:]))])


def _resolve_device(device, mesh: "BatchMesh | None") -> torch.device:
    """The detector's device: ``device``, else the mesh's first entry, else
    "cuda".  A ``device`` that contradicts the mesh raises."""
    if mesh is None:
        return torch.device("cuda" if device is None else device)
    first = mesh.devices[0]
    if device is not None:
        d = torch.device(device)
        if d.type != first.type or d.index not in (None, first.index):
            raise ValueError(f"device {device!r} contradicts the mesh, whose first entry is "
                             f"{first}")
    return first


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
    ``"obj*cls"``.  ``interp`` is the letterbox resize, "linear" or
    "cubic" (Keys, as ``jax.image.resize``).  ``cfg_text`` (set by
    ``load``) makes the detector checkpointable; ``keep_fp32_params=False``
    drops the host fp32 copy of the params, after which a bf16 detector
    cannot ``save_checkpoint``.  ``stem_s2d`` runs the space-to-depth stem (an exact
    reparameterization of the first two layers).  The default is off, where the JAX package turns it on for bf16 and int8
    serving of a Darknet-53 stem: on an H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase 12,
    bf16 yolov3@416 batch 128, every conv on K5, in turns off/on/on/off) the s2d stem
    was 8.98 % slower (37.038 / 37.069 against 33.707 / 33.747 ms/batch, live weights),
    beyond the 0.2-0.8 % that runs of one code differ by: K5's packed route takes the
    plain stem's 3-channel conv, and the s2d stem's 12-channel conv takes the gather.
    ``PYTORCH_YOLO_STEM_S2D=1`` turns it on where the stem is conv_conv or
    conv_pool and its convs stay fp; ``=0`` keeps it off.

    ``mesh`` (a ``parallel.sharding.BatchMesh``) serves every batch split
    over its entries, shard i on entry i's device; ``device`` defaults to
    its first entry.  The ``mesh`` attribute is always a mesh: one entry,
    the detector's device, where none is given (``mesh.size > 1`` where a
    batch is split).  Calibration and the equalizer run once, on that
    device, before the replicas are made (one a distinct device; repeated
    entries share one); ``model`` is the first replica.  A batch must
    divide the mesh: ``detect_batch``, ``detect_many``, ``detect_stream``
    and ``warmup`` pad it (``_pad_to_mesh``) and trim the padding,
    ``raw_result`` and ``detect_prepared`` raise."""

    def __init__(
        self,
        spec: ModelSpec,
        params: Params,
        class_names: Sequence[str] | None = None,
        device: "str | torch.device | None" = None,
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
        cfg_text: "str | None" = None,
        interp: str = "linear",
        keep_fp32_params: bool = True,
        mesh: "BatchMesh | None" = None,
    ) -> None:
        self.device = _resolve_device(device, mesh)
        self.mesh = mesh if mesh is not None else BatchMesh((self.device,))
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but torch.cuda.is_available() "
                               "is False")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        if score_mode not in ("obj", "obj*cls"):
            raise ValueError(f"unknown score_mode {score_mode!r} ('obj' or 'obj*cls')")
        if interp not in ("linear", "cubic"):
            raise ValueError(f"interp must be 'linear' or 'cubic', got {interp!r}")
        self.spec = spec
        self.cfg_text = cfg_text
        self.interp = interp
        self.weights_source: "str | None" = None  # set by load(); None = synthetic
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
        # Checkpoints are fp32 canonical: keep the fp32 host params (the
        # caller's arrays, not a copy) where they arrived fp32 and unquantized.
        self._fp32_params = None
        if keep_fp32_params and quant is None:
            host = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in params.items()}
            if all(a.dtype == np.float32 for p in host.values() for a in p.values()):
                self._fp32_params = host
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
        # one replica an entry of the mesh (repeated devices share one)
        self._replicas = replicate_params(
            Darknet(spec, params, dtype=dtype, precision=precision, quant=quant,
                    stem_s2d=self.stem_s2d), self.mesh)
        self.model = self._replicas[0]
        self._pipelines: "collections.OrderedDict[_PipelineKey, object]" = (
            collections.OrderedDict())
        self.max_cached_pipelines = 32  # LRU bound for long-running servers
        # pinned host buffers of the prepared path, by (device, shape, dtype):
        # a ring of slots, each with the event of its last copy
        self._staging: "collections.OrderedDict[tuple, list]" = collections.OrderedDict()

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
        device: "str | torch.device | None" = None,
        dtype: torch.dtype = torch.float32,
        precision: str = "highest",
        synthetic: str = "he",
        **kw,
    ) -> "Detector":
        """``cfg`` is a ``.cfg`` path or a zoo model name ("yolov3",
        "yolov3-tiny", ...: ``models.zoo.available_models()``).  With
        ``weights=None`` the model gets
        synthetic weights, the same numbers as the JAX package's:
        ``synthetic="he"`` is plain He init (deep models saturate their head
        sigmoids), ``"live"`` adds the LSUV variance equalizer
        (``weights.equalize_raw_params``, run on ``device``), which puts the
        head logits in the sigmoid's responsive range.  ``kw`` are the
        constructor's other arguments (``mesh``, ``score_mode``,
        ``stem_s2d``, ``interp``, ``keep_fp32_params``, ``quant*``)."""
        if cfg.endswith(".cfg"):
            with open(cfg, "r", encoding="utf-8") as f:
                cfg_text = f.read()
        else:
            from .models.zoo import _GENERATORS

            if cfg not in _GENERATORS:
                raise ValueError(f"unknown model {cfg!r}: a .cfg path or one of "
                                 f"{sorted(_GENERATORS)}")
            cfg_text = _GENERATORS[cfg]()
        spec = build_spec(parse_cfg_text(cfg_text))
        if weights is not None:
            params = load_weights(spec, weights)  # the C++ loader where it builds, else numpy
        else:
            if synthetic not in ("he", "live"):
                raise ValueError(f"unknown synthetic regime {synthetic!r} (expected 'he' or "
                                 "'live')")
            raw = random_raw_params(spec)
            if synthetic == "live":
                raw = equalize_raw_params(spec, raw,
                                          device=_resolve_device(device, kw.get("mesh")))
            params = fold_batchnorm(spec, raw)
        det = cls(spec, params, class_names=load_classes(names),
                  device=device, dtype=dtype, precision=precision, cfg_text=cfg_text, **kw)
        det.weights_source = weights  # None = synthetic random (provenance)
        return det

    def save_checkpoint(self, path: str) -> None:
        """Persist the folded fp32 params + cfg text (+ class names) to the
        directory ``path``, in the JAX package's layout: either package
        loads it (``utils/checkpoint.py``)."""
        from .utils.checkpoint import save_checkpoint

        if self.cfg_text is None:
            raise ValueError("detector has no cfg text to checkpoint")
        if self.quant is not None:
            raise ValueError(
                "cannot checkpoint an int8-quantized detector; checkpoints are "
                "fp32 canonical — load without quant, checkpoint, then requantize")
        params = self._fp32_params
        if params is None:
            if self.dtype != torch.float32 or self.stem_s2d:
                raise ValueError("cannot checkpoint non-fp32 params: this detector was built "
                                 "with keep_fp32_params=False (or from non-fp32 params); "
                                 "checkpoints are fp32 canonical")
            params = {int(i): {"w": c.weight.detach().cpu().numpy(),
                               "b": c.bias.detach().cpu().numpy()}
                      for i, c in self.model.convs.items()}
        save_checkpoint(path, self.cfg_text, params, self.class_names)

    @classmethod
    def from_checkpoint(cls, path: str, **kw) -> "Detector":
        """A detector from a checkpoint directory written by either package;
        ``kw`` are the constructor's other arguments."""
        from .utils.checkpoint import load_checkpoint

        spec, cfg_text, params, names = load_checkpoint(path)
        return cls(spec, params, class_names=names, cfg_text=cfg_text, **kw)

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
        if key.batch == 1 and self.quant == "w8a8":
            log.warning(
                "building a batch-1 pipeline on an int8 (w8a8) detector: at batch 1 int8sb "
                "measured slower than bf16 on an H100 80GB HBM3 at 700 W (yolov3@416, "
                "detect_stream, the median of 3 windows of 480 frames: 9.268 ms a frame, "
                "8.654-9.901, against 5.748, 5.220-6.372; chip_smoke.py phase 15); serve "
                "batch 1 with bf16 instead")
        replicas, spec, interp, home = self._replicas, self.spec, self.interp, self.device

        def postprocess(xs, unletterbox) -> NMSResult:
            """Shard i's forward (in lockstep with the others), K1, top-K, K2
            and ``unletterbox(i, boxes)`` on its device; the results
            gathered on the first device."""
            parts = []
            for i, heads in enumerate(Darknet.forward_mesh(replicas, xs, _native_heads=True)):
                rows = decode_score_all(heads, spec, score_mode=key.score_mode)  # bf16 as they are
                res = batched_nms_fused(rows, conf_thresh=key.conf, iou_thresh=key.iou,
                                        max_det=key.max_det)
                parts.append(res._replace(boxes=unletterbox(i, res.boxes)))
            return NMSResult(*(gather_batch(field, home) for field in zip(*parts)))

        if key.prepared:
            # host-letterboxed canvases with one geometry row an image: one
            # pipeline serves every source resolution
            def prepared(xs, geos) -> NMSResult:
                # uint8 transfer: / 255 on the device, as letterbox_batch divides
                xs = [x.to(torch.float32).mul_(1.0 / 255.0) if x.dtype == torch.uint8 else x
                      for x in xs]
                return postprocess(xs, lambda i, b: unletterbox_boxes_dynamic(b, geos[i]))

            return prepared
        geo = letterbox_geometry(key.orig_h, key.orig_w, key.size)

        def pipeline(shards) -> NMSResult:
            xs = [letterbox_batch(s, size=key.size, bgr=key.bgr, method=interp) for s in shards]
            return postprocess(xs, lambda i, b: unletterbox_boxes(b, geo))

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

    def _pad_to_mesh(self, x, geos: "np.ndarray | None" = None, rows: int = 0):
        """Pad a (usually batch-1) dispatch with zero frames (and identity
        geometries) up to a multiple of the mesh size, at least ``rows``;
        callers trim back with :meth:`_trim`.  Off-mesh it pads to ``rows``
        only."""
        k = pad_to_multiple(max(x.shape[0], rows), self.mesh.size) - x.shape[0]
        if k:
            x = _pad_rows(x, k)
            if geos is not None:
                geos = np.concatenate([np.asarray(geos, np.float32),
                                       np.tile([_IDENTITY_GEO], (k, 1)).astype(np.float32)])
        return (x, geos) if geos is not None else x

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
        or torch tensor on any device).  On a mesh the batch is padded to a
        multiple of the mesh size and the padding trimmed."""
        res = self.raw_result(self._pad_to_mesh(images), size, conf, iou, max_det, bgr)
        return self._trim(res, images.shape[0])

    def raw_result(self, images, size: "int | tuple[int, int] | None" = None,
                   conf: float = 0.5, iou: float = 0.4, max_det: int = 300,
                   bgr: bool = True) -> NMSResult:
        """Device-resident fixed-shape result (no host trim) — for pipelining.

        No mesh padding (the caller owns the batch's geometry): on a mesh a
        batch that does not divide its size raises.  The result lies on
        the detector's device (the mesh's first)."""
        if images.ndim != 4:
            raise ValueError(f"expected (N, H, W, C) uint8 batch, got {tuple(images.shape)}")
        if images.shape[0] % self.mesh.size:
            raise ValueError(
                f"raw_result batch {images.shape[0]} must divide the mesh size "
                f"{self.mesh.size}; use detect_batch for auto-padding")
        shards = shard_batch(_normalize_channels(images), self.mesh)
        key = _PipelineKey(batch=images.shape[0], orig_h=images.shape[1],
                           orig_w=images.shape[2], size=self._resolve_size(size), conf=conf,
                           iou=iou, max_det=max_det, bgr=bgr, score_mode=self.score_mode)
        return self._pipeline(key)(shards)

    def _stage(self, arr, device: torch.device) -> torch.Tensor:
        """A host array (or tensor) on ``device``.  On a card it is copied
        into a pinned staging buffer and sent with a ``non_blocking`` copy
        on the card's current stream, so the host goes on (letterboxing the
        next chunk) while it travels.  Each (device, shape, dtype) has a ring
        of three buffers for each of the device's mesh entries, and a buffer
        is reused only after its last copy is done: the event of the copy
        is recorded on the stream that carried it."""
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
        if device.type != "cuda" or t.device.type != "cpu":
            return t.to(device)
        key = (device, tuple(t.shape), t.dtype)
        ring = self._staging.get(key)
        if ring is None:
            ring = [0] + [[torch.empty(key[1], dtype=t.dtype, pin_memory=True), None]
                          for _ in range(3 * self.mesh.devices.count(device))]
            self._staging[key] = ring
            while len(self._staging) > 8 * self.mesh.size:
                self._staging.popitem(last=False)
        else:
            self._staging.move_to_end(key)
        ring[0] = ring[0] % (len(ring) - 1) + 1
        slot = ring[ring[0]]
        if slot[1] is not None:
            slot[1].synchronize()  # its last copy has left the buffer
        slot[0].copy_(t)
        out = slot[0].to(device, non_blocking=True)
        slot[1] = torch.cuda.Event()
        slot[1].record(torch.cuda.current_stream(device))
        return out

    def detect_prepared(self, x, geos, size: "int | tuple[int, int]", conf: float = 0.5,
                        iou: float = 0.4, max_det: int = 300) -> NMSResult:
        """Run the shape-agnostic pipeline on host-letterboxed inputs.

        ``x``: (N, Sh, Sw, 3) from :func:`letterbox_host` — float32 in [0, 1],
        or uint8 0..255 (``out_dtype="uint8"``; divided on the device, a
        quarter of the bytes to copy); ``geos``: (N, 5) float32 [scale,
        pad_x, pad_y, orig_w, orig_h].  One pipeline a batch size serves
        every source resolution.  Returns the device-resident result (no
        host trim).  On a mesh each shard is staged straight to its device
        (never through the first), and a batch that does not divide the
        mesh raises."""
        n, m = x.shape[0], self.mesh.size
        if n % m:
            raise ValueError(f"detect_prepared batch {n} must divide the mesh size {m}; pad "
                             "it with _pad_to_mesh")
        key = _PipelineKey(batch=n, orig_h=0, orig_w=0, size=size, conf=conf, iou=iou,
                           max_det=max_det, bgr=False, score_mode=self.score_mode,
                           prepared=True)
        fn = self._pipeline(key)
        geos, k = np.asarray(geos, np.float32), n // m
        return fn([self._stage(x[i * k:(i + 1) * k], d) for i, d in enumerate(self.mesh.devices)],
                  [self._stage(geos[i * k:(i + 1) * k], d)
                   for i, d in enumerate(self.mesh.devices)])

    def detect_many(self, images: Sequence, size: "int | tuple[int, int] | None" = None,
                    conf: float = 0.5, iou: float = 0.4, max_det: int = 300, bgr: bool = True,
                    batch: int = 8, transfer: str = "f32") -> list[Detection]:
        """Detect over a list of differently-sized images with true batching.

        Each image is letterboxed on the host and the canvases are stacked
        into chunks of ``batch`` for the prepared pipeline (the last chunk
        padded, so every chunk reuses one pipeline).  Chunks are double
        buffered: the host letterbox of chunk t+1 runs while the device
        works on chunk t.  ``transfer="u8"`` ships rounded uint8 canvases
        (a quarter of the bytes; <= 0.5/255 rounding a pixel).  On a mesh
        each chunk is padded up to a multiple of the mesh size as well."""
        rsize = self._resolve_size(size)
        out_dtype = _transfer_dtype(transfer)
        out: list[Detection] = []
        pending: "tuple[NMSResult, int] | None" = None

        def prepare(chunk):
            lbs, geos = [], []
            for im in chunk:
                lb, g = letterbox_host(_normalize_channels(im), rsize, bgr=bgr,
                                       method=self.interp, out_dtype=out_dtype)
                lbs.append(lb)
                geos.append([g.scale, g.pad_x, g.pad_y, g.orig_w, g.orig_h])
            # pad so every chunk reuses one pipeline
            x, ge = self._pad_to_mesh(np.stack(lbs), np.asarray(geos, np.float32), rows=batch)
            return x, ge, len(chunk)

        for start in range(0, len(images), batch):
            x, ge, n = prepare(images[start:start + batch])
            res = self.detect_prepared(x, ge, rsize, conf=conf, iou=iou, max_det=max_det)
            if pending is not None:
                out.extend(self._trim(*pending))
            pending = (res, n)
        if pending is not None:
            out.extend(self._trim(*pending))
        return out

    def detect_stream(self, images, size: "int | tuple[int, int] | None" = None,
                      conf: float = 0.5, iou: float = 0.4, max_det: int = 300, bgr: bool = True,
                      depth: int = 2, host_preproc: bool = False, transfer: str = "f32"):
        """Pipelined detection over an iterable of (H, W, 3) uint8 images.

        Keeps ``depth`` batches of one in flight on the device, so the host
        work of item t+1 (decode, letterbox, bookkeeping) overlaps the
        device work of item t; yields :class:`Detection` in input order.
        ``host_preproc=True`` letterboxes on the host and feeds the prepared
        pipeline (heterogeneous source sizes share it).  On a mesh each
        dispatch is padded to the mesh size (the results trimmed to 1)."""
        inflight: collections.deque = collections.deque()
        rsize = self._resolve_size(size)
        out_dtype = _transfer_dtype(transfer)

        def dispatch(img) -> None:
            if host_preproc:
                lb, geo = letterbox_host(_normalize_channels(img), rsize, bgr=bgr,
                                         method=self.interp, out_dtype=out_dtype)
                geos = np.asarray([[geo.scale, geo.pad_x, geo.pad_y, geo.orig_w, geo.orig_h]],
                                  dtype=np.float32)
                x, geos = self._pad_to_mesh(lb[None], geos)
                inflight.append(self.detect_prepared(x, geos, rsize, conf=conf, iou=iou,
                                                     max_det=max_det))
            else:
                inflight.append(self.raw_result(self._pad_to_mesh(img[None]), size=size,
                                                conf=conf, iou=iou, max_det=max_det, bgr=bgr))

        it = iter(images)
        for img in it:
            dispatch(img)
            if len(inflight) >= depth:
                break
        for img in it:
            res = inflight.popleft()
            dispatch(img)
            yield self._trim(res, 1)[0]
        while inflight:
            yield self._trim(inflight.popleft(), 1)[0]

    def warmup(self, shapes: Sequence[tuple[int, int]], sizes: Sequence[int] = (416,),
               batch: int = 1, **kw) -> None:
        """Build and run once the pipelines of the given (H0, W0) x size
        buckets (on the card: the kernel library and every launch's
        first-call set-up); on a mesh ``batch`` is padded to its size."""
        for h, w in shapes:
            dummy = np.zeros((batch, h, w, 3), dtype=np.uint8)
            for s in sizes:
                self.detect_batch(dummy, size=s, **kw)

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

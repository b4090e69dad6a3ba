"""The hand-written CUDA kernels, their plain versions, and their build.

* **K1** :func:`decode_score_all` / :func:`decode_score_head`
  (``csrc/decode_score.cu``): every head's raw map, bf16 or fp32, -> one
  (N, D, 8) buffer of rows ``[x1, y1, x2, y2, obj, cls_score, cls_id,
  rank]`` in one launch (``pytorch_yolo_tpu/ops/pallas_kernels.py:
  decode_score_head``); :func:`decode_plan` is its launch table.
* **K2** :func:`nms_keep` (``csrc/nms_keep.cu``): batched greedy-NMS keep
  mask, the overlap bitmask built by the whole block and scanned by one
  warp (``pallas_kernels.py: nms_keep_pallas``); above K = 1024 the
  bitmask is built in a global-memory scratch and scanned by one block.
* **K3** :func:`int8_gemm` (``csrc/gemm_i8.cu``): s8 x s8 -> s32 GEMM with
  the probe's fixed-point requant (``tools/int8_kernel_probe.py:
  gemm_i8_pallas``) or the int8 serving epilogue; every quantized 1x1
  stride-1 conv.
* **K4** :func:`int8_conv` (``csrc/int8_conv.cu``): int8 implicit-GEMM conv
  with the serving epilogue (``pytorch_yolo_tpu/ops/quant.py:
  quantized_conv``); every other quantized conv.  The int8 RGB stem (3x3,
  C = 3) takes K4's packed route (``csrc/int8_packed.cu``): a 32-byte row
  of A a pixel, one ``wgmma`` k32 step (:func:`int8_packed_rows` models
  its rows).
* **K5** :func:`conv_bf16` (``csrc/conv_bf16.cu``, ``conv_bf16_packed.cu``,
  ``conv_bf16_halo.cu`` over ``conv_bf16.cuh``): bf16 implicit-GEMM conv
  with fp32 accumulators and the JAX epilogue (fp32 bias, activation, one
  rounding to bf16, optional shortcut add) on the wgmma core
  (``pytorch_yolo_tpu/models/darknet.py: _conv``); every fp conv of a bf16
  detector, A's route from :func:`conv_bf16_plan`.
* **K6** :func:`quantize_i8` and :func:`absmax` (``csrc/quantize_i8.cu``):
  the int8 input quantizer ``clamp(round(x / sx), -127, 127)`` of a bf16 or
  fp32 input at a scalar or per-channel scale, or of a route's sources
  written as their concatenation (each at its own scale), and the dynamic
  scale ``max|x| / 127 + eps``, written by the reduction itself (XLA's
  fusion in ``pytorch_yolo_tpu/ops/quant.py: quantized_conv``); every int8
  conv input that is not int8-resident.

K3 and K4 run on the Hopper core ``csrc/int8_wgmma.cuh`` (wgmma, TMA, a
warp-specialised ring, persistent blocks) whenever C and the group offsets
are multiples of 16 (:func:`igemm_plan`); the RGB stem on the packed route,
counted as ``int8_conv_packed``; the ``mma.sync`` core
``csrc/int8_igemm.cuh`` keeps the byte path, counted apart as
``int8_gemm_mma`` / ``int8_conv_mma``.  Both take a Darknet [shortcut]
operand into their fp32 epilogue (``shortcut=``).

Each has a plain torch version beside it (``*_ref``).  A wrapper takes the
plain version only when its input lies on the CPU; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, so a
run can show that the main path went through the kernels.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` (Hopper)
into ``csrc/_build/``: one nvcc per source, all started together, then one
link into a shared library with a plain C interface, loaded with
``ctypes``.  The build reruns when a source or header is newer than the
library, and a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import os
import shutil
import subprocess
import threading
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelSpec, head_strides
from .decode import head_decode_args
from .xla_mish import logistic, mish_factor

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = tuple(os.path.join(CSRC, f) for f in
                ("decode_score.cu", "nms_keep.cu", "gemm_i8.cu", "int8_conv.cu",
                  "int8_packed.cu", "conv_bf16.cu", "conv_bf16_packed.cu", "conv_bf16_halo.cu",
                  "quantize_i8.cu"))
HEADERS = tuple(os.path.join(CSRC, f) for f in ("int8_igemm.cuh", "int8_wgmma.cuh",
                                                "device_guard.cuh", "conv_bf16.cuh"))
BUILD_DIR = os.path.join(CSRC, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libyolo_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"decode_score": 0, "nms_keep": 0, "int8_gemm": 0, "int8_gemm_mma": 0,
            "int8_conv": 0, "int8_conv_mma": 0, "int8_conv_packed": 0, "conv_bf16": 0,
            "quantize_i8": 0, "absmax": 0}

MAX_ANCHORS = 8         # csrc/decode_score.cu: kMaxAnchors
MAX_HEADS = 8           # csrc/decode_score.cu: kMaxHeads, heads in one K1 launch
DECODE_TILE_ROWS = 128  # csrc/decode_score.cu: kTileRows, rows a K1 tile
MAX_NMS_K_SHARED = 1024  # csrc/nms_keep.cu: kMaxK, the bitmask in shared memory up to here
_SMEM_LIMIT = 227 * 1024
_CLS_ACT = {"sigmoid": 0, "softmax": 1, "linear": 2}
_SCORE_MODE = {"obj": 0, "obj*cls": 1}

_lock = threading.Lock()
_lib: "ctypes.CDLL | None" = None


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused the kernel sources."""


# ---------------------------------------------------------------------------
# Build and load
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise KernelBuildError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                           "the CUDA kernels cannot be built")


def _is_fresh() -> bool:
    try:
        built = os.path.getmtime(LIBRARY)
    except OSError:
        return False
    return all(os.path.getmtime(s) <= built for s in SOURCES + HEADERS)


def build(force: bool = False) -> str:
    """Compile the kernel library if it is missing or stale; returns its path.

    One nvcc process per source, all running at once, then one link."""
    if not force and _is_fresh():
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, tag = _nvcc(), os.getpid()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o") for src in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src] for src, obj in zip(SOURCES, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate() for p in procs]
    log = []
    for cmd, proc, (out, err) in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc exited {proc.returncode}: {' '.join(cmd)}\n{err}")
        log.append(" ".join(cmd) + "\n" + out + err)
    tmp = f"{LIBRARY}.{tag}.tmp"
    link = [nvcc, "-shared", "-o", tmp, *objs]
    proc = subprocess.run(link, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc exited {proc.returncode}: {' '.join(link)}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    for obj in objs:
        os.remove(obj)
    with open(BUILD_LOG, "w", encoding="utf-8") as f:
        f.write("".join(log) + " ".join(link) + "\n" + proc.stdout + proc.stderr)
    return LIBRARY


def load_library() -> ctypes.CDLL:
    """ctypes handle to the kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.yolo_decode_score.argtypes = [ctypes.POINTER(_DecodeArgs), i, i, p]
            lib.yolo_nms_keep.argtypes = [p, p, p, p, p, i, i, ctypes.c_float, i, p]
            lib.yolo_conv_bf16.argtypes = [ctypes.POINTER(_ConvBf16Args), i, i, i, p]
            lib.yolo_quantize_i8.argtypes = [ctypes.POINTER(_QuantArgs), i, p]
            lib.yolo_absmax.argtypes = [ctypes.POINTER(_QuantArgs), i, p]
            lib.yolo_int8_conv_packed.argtypes = [ctypes.POINTER(_IgemmArgs), i, p]
            for fn in (lib.yolo_decode_score, lib.yolo_nms_keep, lib.yolo_conv_bf16,
                       lib.yolo_quantize_i8, lib.yolo_absmax, lib.yolo_int8_conv_packed):
                fn.restype = i
            for fn in (lib.yolo_int8_gemm, lib.yolo_int8_conv, lib.yolo_int8_gemm_mma,
                       lib.yolo_int8_conv_mma):
                fn.argtypes = [ctypes.POINTER(_IgemmArgs), i, i, p]
                fn.restype = i
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def _check_hopper(index: int) -> None:
    cap = torch.cuda.get_device_capability(index)
    if cap != (9, 0):
        raise RuntimeError(f"cuda:{index} has compute capability {cap}; the kernels are "
                           "built for sm_90a (Hopper) only")


def _cuda_device(name: str, *tensors: "torch.Tensor | None") -> tuple[int, int]:
    """Check that every tensor lies on one CUDA device; returns (device
    index, current stream handle)."""
    dev = tensors[0].device
    for t in tensors:
        if t is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    _check_hopper(dev.index)
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def _cuda_args(name: str, *tensors: "torch.Tensor | None") -> tuple[int, int]:
    """:func:`_cuda_device`, and every tensor contiguous."""
    if any(t is not None and not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: inputs must be contiguous")
    return _cuda_device(name, *tensors)


def _on_grid(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on the 16-byte grid that the kernels' vector
    copies need: a view with an offset may sit off it, and is then copied."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _launch(name: str, entry, *args) -> None:
    """Call the library's C ``entry`` and count the launch.  Each entry
    launches on the device it is given and gives the calling thread its
    current device back (``csrc/device_guard.cuh``), so a launch on one
    card of a mesh leaves torch's current device as it found it."""
    rc = entry(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


# ---------------------------------------------------------------------------
# K1: fused decode + score
# ---------------------------------------------------------------------------


def decode_score_head_ref(
    raw: torch.Tensor,
    anchors: tuple[tuple[float, float], ...],
    stride: int,
    num_classes: int,
    score_mode: str = "obj",
    cls_act: str = "sigmoid",
    scale_xy: float = 1.0,
    new_coords: bool = False,
) -> torch.Tensor:
    """Plain torch version of K1: (N, Gy, Gx, A*(5+C)) -> (N, Gy*Gx*A, 8).

    Same arithmetic as the kernel: the class max and first argmax are taken
    over the logits, then activated (sigmoid, softmax ``1/sum exp(l - l_best)``
    or linear)."""
    n, gy, gx, ch = raw.shape
    a = len(anchors)
    rows = gy * gx * a
    x = raw.reshape(n, rows, 5 + num_classes).to(torch.float32)
    r = torch.arange(rows, device=raw.device)
    cell, anc_i = r // a, r % a
    cx = (cell % gx).to(torch.float32)
    cy = (cell // gx).to(torch.float32)
    anc = torch.tensor(anchors, dtype=torch.float32, device=raw.device)
    pw, ph = anc[anc_i, 0], anc[anc_i, 1]

    s = float(stride)
    al, sh = float(scale_xy), 0.5 * (float(scale_xy) - 1.0)
    if new_coords:
        bx = (x[..., 0] * al - sh + cx) * s
        by = (x[..., 1] * al - sh + cy) * s
        bw = pw * torch.square(2.0 * x[..., 2])
        bh = ph * torch.square(2.0 * x[..., 3])
        obj = x[..., 4]
    else:
        bx = (torch.sigmoid(x[..., 0]) * al - sh + cx) * s
        by = (torch.sigmoid(x[..., 1]) * al - sh + cy) * s
        bw = pw * torch.exp(x[..., 2])
        bh = ph * torch.exp(x[..., 3])
        obj = torch.sigmoid(x[..., 4])
    logits = x[..., 5:]
    best = logits.amax(dim=-1)
    cls_id = logits.argmax(dim=-1).to(torch.float32)  # first index at the max
    if cls_act == "softmax":
        cls_score = 1.0 / torch.exp(logits - best[..., None]).sum(dim=-1)
    elif cls_act == "linear":
        cls_score = best
    else:
        cls_score = torch.sigmoid(best)
    rank = obj if score_mode == "obj" else obj * cls_score
    half_w, half_h = bw * 0.5, bh * 0.5
    return torch.stack([bx - half_w, by - half_h, bx + half_w, by + half_h,
                        obj, cls_score, cls_id, rank], dim=-1)


class HeadPlan(NamedTuple):
    """One head's entry in K1's launch table (:func:`decode_plan`)."""

    batch: int
    gy: int
    gx: int
    anchors: tuple
    stride: int
    classes: int
    cls_act: str
    scale_xy: float
    new_coords: bool
    rows: int        # rows an image, Gy*Gx*A
    out_row0: int    # the head's first row in an image of the (N, D, 8) output
    first_tile: int  # tiles of DECODE_TILE_ROWS rows, numbered across heads
    tiles: int       # ceil(N * rows / DECODE_TILE_ROWS)


def _head_plan(shape, anchors, stride, classes, cls_act="sigmoid", scale_xy=1.0,
               new_coords=False, out_row0=0, first_tile=0) -> HeadPlan:
    n, gy, gx, ch = shape
    a = len(anchors)
    if ch != a * (5 + classes):
        raise ValueError(f"head has {ch} channels, expected {a}*(5+{classes})")
    if cls_act not in _CLS_ACT:
        raise ValueError(f"unknown cls_act {cls_act!r}")
    rows = gy * gx * a
    return HeadPlan(n, gy, gx, tuple(anchors), stride, classes, cls_act, scale_xy,
                    bool(new_coords), rows, out_row0, first_tile,
                    -(-n * rows // DECODE_TILE_ROWS))


_PLANS: dict = {}  # (id(spec), shapes) -> (spec, plans): a step reuses its table


def decode_plan(shapes, spec: ModelSpec) -> tuple[HeadPlan, ...]:
    """K1's launch table for heads of the given (N, Gy, Gx, A*(5+C)) shapes
    (or tensors) of ``spec``: each head's decode arguments, its row range in
    the (N, D, 8) output and its tiles.  Head h's tile ``first_tile + t``
    holds its rows ``[t * DECODE_TILE_ROWS, (t + 1) * DECODE_TILE_ROWS)`` of
    N * rows (image-major), row ``n * rows + r`` going to output row
    ``out_row0 + r`` of image n.  D is the last entry's ``out_row0 + rows``.
    Tables are cached by spec and shapes: ``spec.yolo_layers`` walks every
    layer on each call, which cost more host time than the kernel."""
    shapes = tuple(tuple(getattr(s, "shape", s)) for s in shapes)
    hit = _PLANS.get((id(spec), shapes))
    if hit is not None and hit[0] is spec:
        return hit[1]
    plans: list[HeadPlan] = []
    r0 = t0 = 0
    layers = spec.yolo_layers
    for shape, head, stride in zip(shapes, layers, head_strides(spec)):
        anchors, cls_act, sxy, nc = head_decode_args(head, stride)
        plan = _head_plan(shape, anchors, stride, head.classes, cls_act, sxy, nc, r0, t0)
        if plan.batch != (plans[0].batch if plans else plan.batch):
            raise ValueError("heads of one batch must have one batch size")
        plans.append(plan)
        r0 += plan.rows
        t0 += plan.tiles
    if len(plans) != len(layers):
        raise ValueError(f"{len(plans)} heads for a model of {len(layers)}")
    if len(_PLANS) >= 64:
        _PLANS.clear()
    _PLANS[(id(spec), shapes)] = (spec, tuple(plans))
    return tuple(plans)


class _DecodeHead(ctypes.Structure):
    """csrc/decode_score.cu: DecodeHead, field for field."""

    _fields_ = ([("raw", ctypes.c_void_p), ("rows_total", ctypes.c_longlong),
                 ("out_row0", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in ("rows", "gx", "num_anchors", "attrs",
                                               "num_classes", "cls_act", "new_coords",
                                               "first_tile")]
                + [(n, ctypes.c_float) for n in ("stride", "scale_xy", "shift_xy")]
                + [("anchors", ctypes.c_float * (2 * MAX_ANCHORS))])


class _DecodeArgs(ctypes.Structure):
    """csrc/decode_score.cu: DecodeArgs, field for field."""

    _fields_ = ([("head", _DecodeHead * MAX_HEADS), ("out", ctypes.c_void_p),
                 ("out_batch_stride", ctypes.c_longlong)]
                + [(n, ctypes.c_int) for n in ("num_heads", "total_tiles", "score_mode",
                                               "stages", "stage_bytes")])


@functools.lru_cache(maxsize=64)
def _decode_args(plans: tuple[HeadPlan, ...], score_mode: str, elem_bytes: int) -> bytes:
    """K1's launch arguments for a table, without the tensors' addresses."""
    if not 1 <= len(plans) <= MAX_HEADS:
        raise ValueError(f"decode_score: {len(plans)} heads, one launch takes 1..{MAX_HEADS}")
    args = _DecodeArgs(num_heads=len(plans), total_tiles=sum(p.tiles for p in plans),
                       score_mode=_SCORE_MODE[score_mode])
    for slot, p in zip(args.head, plans):
        a, attrs = len(p.anchors), 5 + p.classes
        if not 1 <= a <= MAX_ANCHORS:
            raise ValueError(f"decode_score: {a} anchors, the kernel takes 1..{MAX_ANCHORS}")
        if p.batch * p.rows >= 2 ** 31:
            raise ValueError("decode_score: a head of 2**31 rows or more")
        if 2 * DECODE_TILE_ROWS * attrs * elem_bytes + 128 > _SMEM_LIMIT:
            raise ValueError(f"decode_score: {p.classes} classes exceed the shared-memory ring")
        slot.rows_total, slot.out_row0 = p.batch * p.rows, p.out_row0
        slot.rows, slot.gx, slot.num_anchors, slot.attrs = p.rows, p.gx, a, attrs
        slot.num_classes, slot.cls_act = p.classes, _CLS_ACT[p.cls_act]
        slot.new_coords, slot.first_tile = int(p.new_coords), p.first_tile
        slot.stride, slot.scale_xy = float(p.stride), float(p.scale_xy)
        slot.shift_xy = 0.5 * (float(p.scale_xy) - 1.0)
        slot.anchors[:2 * a] = [float(v) for wh in p.anchors for v in wh]
    return bytes(args)


def _launch_decode(heads, plans: tuple[HeadPlan, ...], out: torch.Tensor,
                   score_mode: str) -> None:
    """One launch of K1 over ``heads`` (CUDA tensors of one dtype, bf16 or
    fp32) into ``out``, an (N, D', 8) fp32 view with contiguous rows."""
    device, stream = _cuda_args("decode_score", *heads)
    dtype = heads[0].dtype
    if dtype not in (torch.bfloat16, torch.float32) or any(h.dtype != dtype for h in heads):
        raise ValueError("decode_score: heads must all be bfloat16 or all float32, got "
                         f"{[h.dtype for h in heads]}")
    if any(h.data_ptr() % 16 for h in heads):
        raise ValueError("decode_score: a head's data is not 16-byte aligned (the bulk copy "
                         "needs it; the kernel does not copy it for you)")
    if out.device != heads[0].device or out.data_ptr() % 16 or out.stride(0) % 4:
        raise ValueError("decode_score: out must be 16-byte aligned on the heads' device")
    args = _DecodeArgs.from_buffer_copy(_decode_args(tuple(plans), score_mode,
                                                     heads[0].element_size()))
    args.out, args.out_batch_stride = out.data_ptr(), out.stride(0)
    for slot, raw in zip(args.head, heads):
        slot.raw = raw.data_ptr()
    _launch("decode_score", load_library().yolo_decode_score, ctypes.byref(args),
            heads[0].element_size(), device, stream)


def decode_score_head(
    raw: torch.Tensor,
    anchors: tuple[tuple[float, float], ...],
    stride: int,
    num_classes: int,
    score_mode: str = "obj",
    cls_act: str = "sigmoid",
    scale_xy: float = 1.0,
    new_coords: bool = False,
    out: "torch.Tensor | None" = None,
) -> torch.Tensor:
    """K1 on one head: (N, Gy, Gx, A*(5+C)) raw, bf16 or fp32 -> (N,
    Gy*Gx*A, 8) fp32 rows.

    ``out``, when given, is an (N, R, 8) fp32 view whose rows are contiguous
    (a row range of a larger (N, D, 8) buffer); the rows are written there."""
    n = raw.shape[0]
    plan = _head_plan(tuple(raw.shape), anchors, stride, num_classes, cls_act, scale_xy,
                      new_coords)
    if score_mode not in _SCORE_MODE:
        raise ValueError(f"unknown score_mode {score_mode!r}")
    if out is None:
        out = torch.empty((n, plan.rows, 8), dtype=torch.float32, device=raw.device)
    elif (tuple(out.shape) != (n, plan.rows, 8) or out.dtype != torch.float32
          or out.stride(2) != 1 or out.stride(1) != 8):
        raise ValueError(f"out must be an ({n}, {plan.rows}, 8) fp32 view with contiguous rows")
    if raw.device.type == "cpu":
        out.copy_(decode_score_head_ref(raw, anchors, stride, num_classes, score_mode,
                                        cls_act, scale_xy, new_coords))
    else:
        _launch_decode([raw], [plan], out, score_mode)
    return out


def decode_score_all(heads: tuple[torch.Tensor, ...], spec: ModelSpec,
                     score_mode: str = "obj") -> torch.Tensor:
    """K1 over every head (bf16 or fp32) -> (N, D, 8) fp32, each head written
    into its row range; one launch on the card."""
    plans = decode_plan(heads, spec)
    out = torch.empty((plans[0].batch, plans[-1].out_row0 + plans[-1].rows, 8),
                      dtype=torch.float32, device=heads[0].device)
    if heads[0].device.type == "cuda":
        _launch_decode(heads, plans, out, score_mode)
        return out
    for raw, p in zip(heads, plans):
        decode_score_head(raw, p.anchors, p.stride, p.classes, score_mode=score_mode,
                          cls_act=p.cls_act, scale_xy=p.scale_xy, new_coords=p.new_coords,
                          out=out[:, p.out_row0:p.out_row0 + p.rows])
    return out


# ---------------------------------------------------------------------------
# K2: greedy-NMS keep mask
# ---------------------------------------------------------------------------


def nms_keep_ref(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                 cls_id: "torch.Tensor | None" = None) -> torch.Tensor:
    """Plain torch version of K2: the parallel fixpoint over (N, K) candidates.

    over[j, i] marks a higher-ranked j (j < i) that overlaps i; a round keeps
    every undecided i with no unkilled overlapper and kills every undecided i
    with a kept overlapper, until every candidate is decided."""
    from .nms import fixpoint_keep, iou_matrix  # nms imports this module

    over = iou_matrix(boxes) > iou_thresh
    if cls_id is not None:
        over &= (cls_id[:, :, None] - cls_id[:, None, :]).abs() < 0.5
    return fixpoint_keep(over, valid)


def nms_scratch_words(n: int, k: int) -> int:
    """u32 words of K2's global-memory bitmask for an (N, K) launch: 0 up
    to K = 1024 (shared memory holds it), else N * words * 32 * words with
    words = ceil(K / 32), K²/8 bytes an image."""
    if k <= MAX_NMS_K_SHARED:
        return 0
    words = -(-k // 32)
    return n * words * 32 * words


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
             cls_id: "torch.Tensor | None" = None) -> torch.Tensor:
    """K2: (N, K, 4) score-sorted corner boxes, (N, K) bool valid, optional
    (N, K) fp32 class ids (class-wise suppression) -> (N, K) bool keep mask.
    Any K >= 1: above 1024 the launch allocates its bitmask scratch
    (:func:`nms_scratch_words`)."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes must be (N, K, 4), got {tuple(boxes.shape)}")
    n, k, _ = boxes.shape
    if tuple(valid.shape) != (n, k) or valid.dtype != torch.bool:
        raise ValueError(f"valid must be ({n}, {k}) bool")
    if cls_id is not None and tuple(cls_id.shape) != (n, k):
        raise ValueError(f"cls_id must be ({n}, {k})")
    if boxes.device.type == "cpu":
        return nms_keep_ref(boxes, valid, iou_thresh, cls_id)

    if boxes.dtype != torch.float32 or (cls_id is not None and cls_id.dtype != torch.float32):
        raise ValueError("nms_keep: boxes and cls_id must be float32")
    if k < 1:
        raise ValueError(f"nms_keep: K={k}, the kernel takes K >= 1")
    device, stream = _cuda_args("nms_keep", boxes, valid, cls_id)
    if boxes.data_ptr() % 16:
        raise ValueError("nms_keep: boxes must be 16-byte aligned")
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    words = nms_scratch_words(n, k)
    scratch = torch.empty(words, dtype=torch.int32, device=boxes.device) if words else None
    _launch("nms_keep", load_library().yolo_nms_keep, boxes.data_ptr(), valid.data_ptr(),
            None if cls_id is None else cls_id.data_ptr(), keep.data_ptr(),
            None if scratch is None else scratch.data_ptr(), n, k, float(iou_thresh), device,
            stream)
    return keep


# ---------------------------------------------------------------------------
# K3 and K4: int8 GEMM and int8 implicit-GEMM conv
# ---------------------------------------------------------------------------

MAX_SPLIT_GROUPS = 4  # csrc/int8_igemm.cuh: kMaxGroups
_ACT = {"linear": 0, "leaky": 1, "mish": 2, "relu": 3, "logistic": 4}
_EPI_ACC, _EPI_FIXED, _EPI_F32, _EPI_I8 = 0, 1, 2, 3
_HOMOGENEOUS = ("leaky", "relu", "linear")  # act(y / s) == act(y) / s for s > 0
_FLT_MIN = torch.finfo(torch.float32).tiny  # fp32's smallest normal


class _IgemmArgs(ctypes.Structure):
    """csrc/int8_igemm.cuh: IgemmArgs, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "w", "out", "sx", "sxg", "ws", "bias", "out_scale", "shortcut")]
                + [(n, ctypes.c_int) for n in
                   ("batch", "H", "W", "C", "Ho", "Wo", "O", "KH", "KW", "stride", "pad", "M",
                    "groups")]
                + [("goff", ctypes.c_int * (MAX_SPLIT_GROUPS + 1))]
                + [(n, ctypes.c_int) for n in ("mode", "act", "out_scale_vec", "pre", "mul", "sh",
                                                "shortcut_bf16")])


def _requant_fixed(acc: torch.Tensor, pre: int, m: int, sh: int) -> torch.Tensor:
    """The probe's fixed-point requant on int32 (``>>`` is an arithmetic shift,
    as XLA's is): ``clip(acc > 0 ? ((acc>>pre)*m)>>sh : ((acc>>pre)*m)>>(sh+3), ±127)``."""
    scaled = (acc >> pre) * m
    y = torch.where(acc > 0, scaled >> sh, scaled >> (sh + 3))
    return torch.clamp(y, -127, 127).to(torch.int8)


def _round_odd(p: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The float64 sum ``s = p + c`` rounded to odd (TwoSum gives its
    error)."""
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    return torch.where((err != 0) & even, torch.nextafter(s, away), s)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, as CUDA's ``__fmaf_rn`` and as the
    JAX package's compiled epilogue (XLA contracts its multiply-adds); the
    arguments broadcast.  The product is exact in float64 (24 + 24 bits),
    and the float64 sum rounded to odd makes the final rounding to fp32 the
    correct one (Boldo & Melquiond, "Emulation of FMA and correctly
    rounded sums", 2008).  Rounding the plain float64 sum instead is wrong
    only where it landed on a midpoint of the fp32 grid (its 29 low bits
    10...0), or below fp32's normal range where that grid is coarser: on
    the CPU only those few elements are rounded to odd (on a device,
    picking them would wait for it, so every element is)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    if s.device.type != "cpu":
        return _round_odd(p, c, s).float()
    out = s.float()
    redo = ((s.view(torch.int64) & 0x1FFFFFFF) == 0x10000000) | (s.abs() < _FLT_MIN)
    if bool(redo.any()):
        out[redo] = _round_odd(p.expand_as(s)[redo], c.expand_as(s)[redo], s[redo]).float()
    return out


def _mish_factor(y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(y, tanh(softplus(y))) of the epilogue's mish: on the CPU with the
    bits of the JAX package's compiled epilogue (``ops/xla_mish.py``), on
    the card with torch's CUDA math, which the kernels share."""
    if y.device.type == "cpu":
        return mish_factor(y)
    return y, torch.tanh(torch.log1p(torch.exp(-torch.abs(y))) + torch.clamp(y, min=0.0))


def _activate(y: torch.Tensor, activation: str) -> torch.Tensor:
    """The epilogue's activation of the fp32 pre-activation ``y``."""
    from ..models.darknet import apply_activation  # darknet imports this module

    if activation == "mish":
        y, t = _mish_factor(y)
        return y * t
    if activation == "logistic" and y.device.type == "cpu":  # XLA:CPU's bits, as mish
        return logistic(y)
    return apply_activation(y, activation)


def _activate_add(y: torch.Tensor, activation: str, s: torch.Tensor) -> torch.Tensor:
    """The activation of the fp32 pre-activation ``y``, plus a [shortcut]
    operand ``s`` (fp32 or bf16, widened), as the JAX forward computes
    ``act(acc * deq + b) + cache[from]`` when XLA:CPU fuses the add into the
    epilogue: mish's last product ``y * tanh(sp)`` is contracted into the
    add (one rounding, :func:`fma`); every other activation's result is
    rounded, then added (``tests/test_torch_quantize_i8.py`` pins both)."""
    s = s.to(torch.float32)
    if activation == "mish":
        return fma(*_mish_factor(y), s)
    return _activate(y, activation) + s


def _serving_epilogue(v: torch.Tensor, ws: torch.Tensor, b: torch.Tensor, activation: str,
                      sx: "torch.Tensor | None", out_scale: "torch.Tensor | None",
                      shortcut: "torch.Tensor | None" = None) -> torch.Tensor:
    """``pytorch_yolo_tpu/ops/quant.py:600-622`` on an fp32 (..., O) sum:
    dequant (``sx * ws``, or ``ws`` alone when ``sx`` is None or a per-channel
    grid), bias, activation (and at fp32 out the ``shortcut`` operand added,
    :func:`_activate_add`); with ``out_scale``, int8 at that scale (leaky,
    relu and linear divide first and activate after, the others activate at
    the true scale, then divide).  ``sum * deq + bias`` is one fused
    multiply-add, as XLA compiles it."""
    deq = ws if sx is None or sx.dim() == 1 else sx * ws
    if out_scale is None:
        if shortcut is not None:
            return _activate_add(fma(v, deq, b), activation, shortcut)
        return _activate(fma(v, deq, b), activation)
    if activation in _HOMOGENEOUS:
        y = _activate(fma(v, deq / out_scale, b / out_scale), activation)
    else:
        y = _activate(fma(v, deq, b), activation) / out_scale
    return torch.clamp(torch.round(y), -127, 127).to(torch.int8)


def _split_sum(parts, sxg: torch.Tensor) -> torch.Tensor:
    """``sum_g float(acc_g) * sxg[g]`` over a split conv's groups, in the
    order XLA:CPU compiles ``quant.py:579-585``: the second group's product
    is rounded and the first's is fused into adding it, then each later
    group's product is fused into the running sum."""
    if len(parts) == 1:
        return parts[0] * sxg[0]
    v = fma(parts[0], sxg[0], parts[1] * sxg[1])
    for g in range(2, len(parts)):
        v = fma(parts[g], sxg[g], v)
    return v


def _epilogue_ref(acc_of, channels: int, *, fixed=None, accumulators=False, ws=None, b=None,
                  activation="linear", sx=None, out_scale=None, sxg=None,
                  splits=None, shortcut=None) -> torch.Tensor:
    """The kernels' epilogue in plain torch (arguments: :func:`int8_gemm`);
    ``acc_of(lo, hi)`` gives the int32 accumulators over input channels
    [lo, hi)."""
    if sxg is not None:  # split concat: per-branch int32 sums, merged in fp32
        bounds = [0, *itertools.accumulate(splits)]
        parts = [acc_of(lo, hi).to(torch.float32) for lo, hi in zip(bounds, bounds[1:])]
        return _serving_epilogue(_split_sum(parts, sxg), ws, b, activation, None, out_scale,
                                 shortcut)
    acc = acc_of(0, channels)
    if accumulators:
        return acc
    if fixed is not None:
        return _requant_fixed(acc, *fixed)
    return _serving_epilogue(acc.to(torch.float32), ws, b, activation, sx, out_scale, shortcut)


def gemm_i8_ref(xq: torch.Tensor, wq: torch.Tensor, **epi) -> torch.Tensor:
    """Plain torch version of K3 (arguments: :func:`int8_gemm`).  The
    accumulators are a float64 product (exact: |acc| <= 127² · K < 2^53),
    rounded and cast to int32."""

    def acc_of(lo, hi):
        return torch.round(xq[:, lo:hi].double() @ wq[:, lo:hi].double().T).to(torch.int32)

    return _epilogue_ref(acc_of, xq.shape[1], **epi)


def int8_conv_ref(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int,
                  **epi) -> torch.Tensor:
    """Plain torch version of K4 on NHWC int8 ``xq`` and (O, KH, KW, C) int8
    ``wq`` (arguments: :func:`int8_conv`).  The accumulators are a float64 ``F.conv2d`` (exact, as for K3;
    rounded, so a conv algorithm with rounding error would still give the
    exact integer), cast to int32."""

    def acc_of(lo, hi):
        y = F.conv2d(xq[..., lo:hi].permute(0, 3, 1, 2).double(),
                     wq[..., lo:hi].permute(0, 3, 1, 2).double(), stride=stride, padding=pad)
        return torch.round(y).to(torch.int32).permute(0, 2, 3, 1).contiguous()

    return _epilogue_ref(acc_of, xq.shape[-1], **epi)


def igemm_plan(channels: int, goff: "list[int]", out_channels: int, split: bool,
               aligned: bool, kh: int, kw: int, stride: int, pad: int,
               shortcut: bool = False) -> tuple[str, int]:
    """The K3/K4 core for a call, from its shapes alone: ``("wgmma", BN)``
    with a BN-column tile when the channel count and every group offset are
    multiples of 16 and both operands are 16-byte aligned (what TMA and the
    16-byte gather need); BN is 256 from 256 output channels on, 128 below
    and for split groups (their fp32 group sums double the accumulators).
    ``("packed", 32)`` for the int8 RGB stem: a 3x3 conv of 3 channels,
    stride 1 or 2, pad 1, 8 to 32 outputs in steps of 8 (one
    ``wgmma.m64n32k32``), one group, no [shortcut] operand, aligned
    (``csrc/int8_packed.cu``).  Else ``("mma", 128)``: the ``mma.sync``
    core's byte path (C or a group offset not a multiple of 16)."""
    if (aligned and channels == 3 and kh == kw == 3 and stride in (1, 2) and pad == 1
            and out_channels % 8 == 0 and 8 <= out_channels <= INT8_PACKED_N and not split
            and not shortcut):
        return "packed", INT8_PACKED_N
    if aligned and channels % 16 == 0 and all(g % 16 == 0 for g in goff):
        return "wgmma", 128 if split or out_channels < 256 else 256
    return "mma", 128


# K4's packed route (csrc/int8_packed.cu): its tile, its shared memory, and
# a numpy model of the rows of A its producer builds.
INT8_PACKED_ROWS = 256  # kRows: output pixels a tile
INT8_PACKED_K = 32      # kK: bytes of a row of A (27 values, 5 zeros) and of W
INT8_PACKED_N = 32      # kN: W's rows, zero past O
INT8_PACKED_SMEM_FIXED = 4 * 256 * 32 + 32 * 32 + 2 * 64 * 160 + 2 * 4 * 8 + 1024  # Layout::kFixed


def int8_packed_slot(wo: int, stride: int) -> int:
    """Bytes of a slice's slot (csrc: slot_bytes): the span of
    ``(min(Wo, 256) - 1) * stride + 3`` pixels of 3 bytes, 15 bytes before
    it for the first copy's alignment and 16 after, to the 16-byte grid."""
    return ((min(wo, INT8_PACKED_ROWS) - 1) * stride + 3) * 3 + 31 + 15 & ~15


def int8_packed_max_segments(wo: int) -> int:
    """Output-row runs ("segments") a tile of 256 pixels can touch
    (csrc: max_segments): 2 from ``Wo >= 255`` on, 256 at ``Wo = 1``."""
    return 1 + (INT8_PACKED_ROWS - 1 + wo - 1) // wo


def int8_packed_smem(wo: int, stride: int) -> int:
    """Shared memory a packed launch asks for: the ring of A, W, the
    epilogue's staging rows, the barriers, and two slice buffers of 3 slots
    a segment (one a tap row) and each slot's 4-byte phase (csrc:
    buffer_bytes)."""
    buffer = 3 * int8_packed_max_segments(wo) * (int8_packed_slot(wo, stride) + 4) + 15 & ~15
    return INT8_PACKED_SMEM_FIXED + 2 * buffer


def _div_by(n: int, d: int) -> int:
    """``n // d`` as csrc/int8_packed.cu divides a pixel's place by Wo and an
    output row by Ho (``fast_div``, ``div_by``): the round-up division of
    CUTLASS's FastDivmod, ``(n * mul >> 32) >> (l - 1)`` with l = ceil(log2
    d) and mul = ceil(2^(31 + l) / d), exact for n in [0, 2^31); d = 1 is
    not divided."""
    if d == 1:
        return n
    l = (d - 1).bit_length()
    return (n * -(-(1 << (31 + l)) // d) >> 32) >> (l - 1)


def int8_packed_weights(wq: np.ndarray) -> np.ndarray:
    """W's 32 x 32 tile of the packed route: row o the 27 int8 of the
    (O, 3, 3, 3) weights' output o in (KH, KW, C) order, then zeros; rows
    past O zero."""
    tile = np.zeros((INT8_PACKED_N, INT8_PACKED_K), np.int8)
    tile[:wq.shape[0], :27] = wq.reshape(wq.shape[0], 27)
    return tile


def _funnel(lo: int, hi: int, sh: int) -> int:
    """CUDA's ``__funnelshift_r(lo, hi, sh)``: ``hi:lo >> sh``, low 32 bits."""
    return ((hi << 32 | lo) >> sh) & 0xFFFFFFFF


def int8_packed_rows(x: np.ndarray, stride: int, tile: int) -> np.ndarray:
    """A numpy model of the A tile that ``csrc/int8_packed.cu``'s producer
    builds for tile ``tile`` of the 3x3, pad-1 conv of NHWC int8 ``x`` (N,
    H, W, 3) at ``stride``, step by step: the tile's geometry by the
    kernel's divisions (:func:`_div_by`); each (segment, tap row) slice
    copied in the 16-byte pieces of x that cover its in-image pixels, the
    last piece cut at x's end, into a slot of stale bytes, and the slot's
    phase (or -1 for a tap row in the padding) into the buffer's table;
    then each row's three 9-byte runs read as three 32-bit words,
    funnel-shifted into place, masked where a tap lies in the padding, and
    packed into 8 words.  Returns (256, 32) int8: row i the 27 values of
    pixel ``256 * tile + i`` in W's (KH, KW, C) order and 5 zeros; rows
    past M zero."""
    n, h, w, c = x.shape
    if c != 3 or stride not in (1, 2):
        raise ValueError(f"int8_packed_rows: (N, H, W, 3) at stride 1 or 2, got {x.shape}, "
                         f"stride {stride}")
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    flat = np.ascontiguousarray(x).view(np.uint8).reshape(-1)
    slot = int8_packed_slot(wo, stride)
    buf = np.full(3 * int8_packed_max_segments(wo) * slot, 0xA5, np.uint8)  # stale bytes
    phases = np.full(3 * int8_packed_max_segments(wo), 0x5A5A5A5A, np.int64)
    m0 = tile * INT8_PACKED_ROWS
    length = min(INT8_PACKED_ROWS, n * ho * wo - m0)
    row0 = _div_by(m0, wo)
    ow0 = m0 - row0 * wo
    first = min(wo - ow0, length)
    for z in range(3 * (_div_by(ow0 + length - 1, wo) + 1)):
        j, r = divmod(z, 3)
        img = _div_by(row0 + j, ho)
        ih = (row0 + j - img * ho) * stride - 1 + r
        ow_a = ow0 if j == 0 else 0
        row = (img * h + ih) * w * 3
        l0 = row + (ow_a * stride - 1) * 3
        phases[z] = l0 & 15 if 0 <= ih < h else -1
        if phases[z] < 0:
            continue
        seg = first if j == 0 else min(wo, length - first - (j - 1) * wo)
        lo, hi = max(ow_a * stride - 1, 0), min((ow_a + seg - 1) * stride + 1, w - 1)
        for g in range(row + lo * 3 & ~15, row + (hi + 1) * 3, 16):
            piece = np.zeros(16, np.uint8)
            piece[:min(16, flat.size - g)] = flat[g:g + 16]
            dst = z * slot + g - (l0 & ~15)
            buf[dst:dst + 16] = piece

    def word(pos: int) -> int:
        return int.from_bytes(buf[pos:pos + 4].tobytes(), "little")

    out = np.zeros((INT8_PACKED_ROWS, INT8_PACKED_K), np.uint8)
    for i in range(length):
        j = _div_by(ow0 + i, wo)
        ow = ow0 + i - j * wo
        col = (ow - (ow0 if j == 0 else 0)) * stride * 3
        x0, x1, x2 = [0] * 3, [0] * 3, [0] * 3
        for r in range(3):
            phase = int(phases[3 * j + r])
            if phase < 0:
                continue
            pos = (3 * j + r) * slot + phase + col
            at, sh = pos & ~3, (pos & 3) * 8
            u0, u1, u2 = word(at), word(at + 4), word(at + 8)
            x0[r], x1[r], x2[r] = _funnel(u0, u1, sh), _funnel(u1, u2, sh), (u2 >> sh) & 0xFF
            if ow == 0:  # the run's first pixel is column -1
                x0[r] &= 0xFF000000
            if ow * stride + 1 >= w:  # its last pixel is column W
                x1[r] &= 0x0000FFFF
                x2[r] = 0
        words = [x0[0], x1[0], x2[0] | x0[1] << 8, _funnel(x0[1], x1[1], 24),
                 x1[1] >> 24 | x2[1] << 8 | x0[2] << 16, _funnel(x0[2], x1[2], 16),
                 x1[2] >> 16 | x2[2] << 16, 0]
        out[i] = np.frombuffer(b"".join((v & 0xFFFFFFFF).to_bytes(4, "little") for v in words),
                               np.uint8)
    return out.view(np.int8)


def igemm_work(x_shape: tuple[int, ...], w_shape: tuple[int, ...], stride: int, pad: int,
               out_bytes: int) -> tuple[int, int]:
    """(int8 ops, bytes) of one K3/K4 launch: ``2 * M * O * KH * KW * C``
    ops (a multiply-add is two), and the NHWC input, the (O, KH, KW, C)
    weights and the (M, O) output each counted once, the output at
    ``out_bytes`` a value (4 for fp32 and int32, 1 for int8)."""
    n, h, w, c = x_shape
    o, kh, kw, _ = w_shape
    m = n * ((h + 2 * pad - kh) // stride + 1) * ((w + 2 * pad - kw) // stride + 1)
    ops = 2 * m * o * kh * kw * c
    return ops, n * h * w * c + o * kh * kw * c + m * o * out_bytes


def _check_shortcut(name: str, shortcut: "torch.Tensor | None", out_shape: tuple[int, ...],
                    epi: dict) -> None:
    """A [shortcut] operand must have the output's shape, be fp32 or bf16,
    and meet the fp32 serving epilogue (no ``out_scale``, accumulators or
    fixed-point requant)."""
    if shortcut is None:
        return
    if tuple(shortcut.shape) != tuple(out_shape):
        raise ValueError(f"{name}: shortcut must be {tuple(out_shape)}, got "
                         f"{tuple(shortcut.shape)}")
    if shortcut.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: shortcut must be float32 or bfloat16, got {shortcut.dtype}")
    if any(epi.get(k) is not None for k in ("out_scale", "fixed")) or epi.get("accumulators"):
        raise ValueError(f"{name}: a shortcut operand takes the fp32 serving epilogue only")


def _igemm(name: str, xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int,
           out_shape: tuple[int, ...], *, fixed=None, accumulators=False, ws=None, b=None,
           activation="linear", sx=None, out_scale=None, sxg=None, splits=None,
           shortcut=None, _mma: bool = False) -> torch.Tensor:
    """Check the arguments of K3/K4 on CUDA tensors and launch the kernel
    that :func:`igemm_plan` picks.  ``xq`` is (N, H, W, C) int8 and ``wq``
    (O, KH, KW, C) int8.  ``_mma=True`` forces the ``mma.sync`` core, for
    timing one core against the other; no serving path passes it."""
    n, h, w, c = xq.shape
    o, kh, kw, _ = wq.shape
    if accumulators:
        mode, out_dtype = _EPI_ACC, torch.int32
    elif fixed is not None:
        mode, out_dtype = _EPI_FIXED, torch.int8
    else:
        mode, out_dtype = (_EPI_F32, torch.float32) if out_scale is None else (_EPI_I8, torch.int8)
        if ws is None or b is None:
            raise ValueError(f"{name}: the dequant epilogue needs ws and b")
        for t, what in ((ws, "ws"), (b, "b")):
            if t.dtype != torch.float32 or tuple(t.shape) != (o,):
                raise ValueError(f"{name}: {what} must be ({o},) float32")
        if (sx is None) == (sxg is None):
            raise ValueError(f"{name}: give exactly one of sx and sxg")
        if sx is not None and (sx.dtype != torch.float32 or sx.dim() > 1
                               or (sx.dim() == 1 and sx.shape[0] != c)):
            raise ValueError(f"{name}: sx must be a 0-d or ({c},) float32 tensor")
        if out_scale is not None and (out_scale.dtype != torch.float32 or out_scale.dim() > 1
                                      or (out_scale.dim() == 1 and out_scale.shape[0] != o)):
            raise ValueError(f"{name}: out_scale must be a 0-d or ({o},) float32 tensor")
    if activation not in _ACT:
        raise ValueError(f"{name}: unknown activation {activation!r}")
    goff = [0, c]
    if sxg is not None:
        if mode not in (_EPI_F32, _EPI_I8):
            raise ValueError(f"{name}: split groups take the dequant epilogue only")
        if (not 1 <= len(splits) <= MAX_SPLIT_GROUPS or min(splits) < 1
                or sum(splits) != c):
            raise ValueError(f"{name}: splits {splits} must be 1..{MAX_SPLIT_GROUPS} positive "
                             f"widths covering {c} channels")
        if sxg.dtype != torch.float32 or tuple(sxg.shape) != (len(splits),):
            raise ValueError(f"{name}: sxg must be ({len(splits)},) float32")
        goff = [0]
        for s in splits:
            goff.append(goff[-1] + s)
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or wq.shape[3] != c:
        raise ValueError(f"{name}: int8 input (..., {c}) and int8 (O, KH, KW, {c}) weights "
                         f"expected, got {xq.dtype} {tuple(xq.shape)} and {wq.dtype} "
                         f"{tuple(wq.shape)}")
    if shortcut is not None:
        shortcut = _on_grid(shortcut)
    scalar = [t for t in (sx, out_scale) if t is not None and t.dim() == 0]
    device, stream = _cuda_args(name, xq, wq, ws, b, sxg, shortcut, *scalar,
                                *[t for t in (sx, out_scale) if t is not None and t.dim() == 1])
    out = torch.empty(out_shape, dtype=out_dtype, device=xq.device)
    aligned = xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    core, bn = igemm_plan(c, goff, o, sxg is not None, aligned, kh, kw, stride, pad,
                          shortcut is not None)
    if _mma or core == "mma":
        # the mma.sync entry takes its 16-byte-copy flag, which needs what wgmma needs
        key, arg = name + "_mma", (int(core == "wgmma"),)
    elif core == "packed":
        key, arg = name + "_packed", ()
    else:  # the wgmma entry takes the tile width
        key, arg = name, (bn,)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    pre, mul, sh = fixed if fixed is not None else (0, 0, 0)
    m = out.numel() // o
    args = _IgemmArgs(
        ptr(xq), ptr(wq), ptr(out), ptr(sx) if sx is not None and sx.dim() == 0 else None,
        ptr(sxg), ptr(ws), ptr(b), ptr(out_scale), ptr(shortcut),
        n, h, w, c, out_shape[1] if len(out_shape) == 4 else 1,
        out_shape[2] if len(out_shape) == 4 else 1, o, kh, kw, stride, pad, m, len(goff) - 1,
        (ctypes.c_int * (MAX_SPLIT_GROUPS + 1))(*goff), mode, _ACT[activation],
        int(out_scale is not None and out_scale.dim() == 1), pre, mul, sh,
        int(shortcut is not None and shortcut.dtype == torch.bfloat16))
    _launch(key, getattr(load_library(), "yolo_" + key), ctypes.byref(args), *arg, device, stream)
    return out


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor, _mma: bool = False, **epi) -> torch.Tensor:
    """K3: (M, K) int8 x (N, K) int8 -> (M, N), the weight operand transposed
    (K contiguous per output column).

    Epilogue keywords, one of: ``accumulators=True`` -> the int32 sums;
    ``fixed=(pre, m, sh)`` -> the probe's fixed-point requant to int8;
    else the serving epilogue (``ws``, ``b``, ``activation`` (default
    "linear"), and ``sx`` a 0-d input scale or a per-channel grid already
    folded into ``wq``, or ``sxg`` + ``splits`` for per-branch scales) ->
    fp32, or int8 at ``out_scale``.  Scales are tensors on the device.  At
    fp32 out, ``shortcut`` (M, N) fp32 or bf16 is a Darknet [shortcut]
    operand added after the activation (:func:`_activate_add`).
    ``_mma`` (CUDA only) forces the ``mma.sync`` core, for A/B timing."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8_gemm: (M, K) and (N, K) expected, got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    _check_shortcut("int8_gemm", epi.get("shortcut"), (xq.shape[0], wq.shape[0]), epi)
    if xq.device.type == "cpu":
        return gemm_i8_ref(xq, wq, **epi)
    (m, k), n = xq.shape, wq.shape[0]
    return _igemm("int8_gemm", xq.view(m, 1, 1, k), wq.view(n, 1, 1, k), 1, 0, (m, n),
                  _mma=_mma, **epi)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int, _mma: bool = False,
              **epi) -> torch.Tensor:
    """K4: NHWC int8 ``xq`` (N, H, W, C) conv (O, KH, KW, C) int8 ``wq``,
    zero padding ``pad`` on each side -> NHWC (N, Ho, Wo, O), with the
    epilogue of :func:`int8_gemm` (a ``shortcut`` is (N, Ho, Wo, O))."""
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[3] != wq.shape[3]:
        raise ValueError(f"int8_conv: (N, H, W, C) and (O, KH, KW, C) expected, got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    n, h, w, _ = xq.shape
    o, kh, kw, _ = wq.shape
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"int8_conv: empty output for {tuple(xq.shape)} with a {kh}x{kw} "
                         f"kernel, stride {stride}, pad {pad}")
    _check_shortcut("int8_conv", epi.get("shortcut"), (n, ho, wo, o), epi)
    if xq.device.type == "cpu":
        return int8_conv_ref(xq, wq, stride, pad, **epi)
    return _igemm("int8_conv", xq, wq, stride, pad, (n, ho, wo, o), _mma=_mma, **epi)


# ---------------------------------------------------------------------------
# K5: bf16 implicit-GEMM conv with the JAX epilogue
# ---------------------------------------------------------------------------


CONV_BF16_ROUTES = {"gather": 0, "tma": 1, "im2col": 2, "packed": 3,  # conv_bf16.cuh: cb::Route
                    "im2col32": 4, "im2col16": 5, "halo": 6, "im2col_pad": 7}
CONV_BF16_STAGE_K = 64  # csrc/conv_bf16.cuh: kStageK, bf16 of K a stage
CONV_BF16_TILE_M = 128  # int8_wgmma.cuh: kBM, output pixels a block tile
CONV_BF16_PACKED_K = 32  # csrc/conv_bf16.cuh: kPackedK, K of the packed route's one stage
CONV_BF16_PACKED_ROWS = 256  # csrc/conv_bf16.cuh: kPackedRows, output pixels a packed tile
CONV_BF16_MAX_STAGES = 512  # csrc/conv_bf16.cuh: kMaxStages, entries (boxes) of the stage table
CONV_BF16_BOXES = 4  # csrc/conv_bf16.cuh: kBoxes, 16-channel boxes a stage of "im2col16"
CONV_BF16_BOX_BN = (32, 48, 64, 80, 128)  # csrc/conv_bf16.cu: launch_boxed's tiles
CONV_BF16_PACKED_BN = (32, 48, 64)  # csrc/conv_bf16_packed.cu: launch_packed's tiles
CONV_BF16_RING = (4, 8)  # csrc/conv_bf16.cuh: kMinRing, kMaxRing, A stages beside a resident W
CONV_BF16_SMEM = 232448  # csrc/conv_bf16.cuh: kSmemLimit, shared memory a block may use
CONV_BF16_SMS = 132  # SMs of an H100 SXM, for the traffic model's count of resident W loads
CONV_BF16_HALO_OUT = 48  # outputs the halo route takes at most (csrc/conv_bf16_halo.cu: BN 32, 48)
CONV_BF16_HALO_TILE = (4, 32)  # csrc/conv_bf16.cuh: kHaloTH, kHaloTW, output pixels a halo tile
CONV_BF16_PAIR_BN = 80  # csrc/conv_bf16.cuh: kPairBN, "im2col_pad"'s tile of a cluster on one M-tile
# K5's launches by route (each also counts in LAUNCHES["conv_bf16"])
CONV_BF16_LAUNCHES = dict.fromkeys(CONV_BF16_ROUTES, 0)


class _ConvBf16Args(ctypes.Structure):
    """csrc/conv_bf16.cuh: ConvBf16Args, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "w", "bias", "shortcut", "out")]
                + [(n, ctypes.c_int) for n in
                   ("batch", "H", "W", "C", "Ho", "Wo", "O", "KH", "KW", "stride", "pad", "M",
                    "act", "lo_w", "lo_h", "hi_w", "hi_h", "stages")]
                + [("stage_tab", ctypes.c_uint32 * CONV_BF16_MAX_STAGES)])


def conv_bf16_ref(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, pad: int,
                  act: str = "linear", shortcut: "torch.Tensor | None" = None) -> torch.Tensor:
    """Plain torch version of K5 (arguments: :func:`conv_bf16`): ``F.conv2d``
    in fp32 (TF32 off) on the bf16 operands, + the fp32 bias, the
    activation in fp32, one rounding to bf16; then ``shortcut`` added as a
    bf16 add (fp32 sum of the two bf16 values, rounded once more).  The
    order of ``pytorch_yolo_tpu/models/darknet.py: _conv`` and of the
    JAX shortcut (``cache[i-1] + cache[from]``)."""
    from ..models.darknet import apply_activation  # darknet imports this module

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.float32),
                     w.permute(0, 3, 1, 2).to(torch.float32), stride=stride, padding=pad)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    y = apply_activation(y + b.to(torch.float32)[:, None, None], act).to(torch.bfloat16)
    y = y.permute(0, 2, 3, 1)
    if shortcut is not None:
        y = (y.to(torch.float32) + shortcut.to(torch.float32)).to(torch.bfloat16)
    return y.contiguous()


def conv_bf16_plan(channels: int, out_channels: int, kh: int, kw: int, stride: int,
                   pad: int) -> tuple[str, int, int]:
    """K5's launch for a conv, from its shapes alone: ``(A's route, BN,
    padded C)``.  A comes by a 2-D TMA box for a 1x1 stride-1 unpadded conv
    (``"tma"``); for a 3x3 conv of 3 channels with at most 64 outputs, the
    RGB stem, it is built from x's 3-channel pixels (``"packed"``: 27 values
    and 5 zeros a row, one 32-wide K stage, a tile of 32, 48 or 64 columns,
    C as it is); by TMA im2col boxes for every other conv with at most
    ``CONV_BF16_MAX_STAGES`` boxes of K: ``"im2col"`` where C % 64 == 0 (a
    stage is 64 channels of one tap), ``"im2col_pad"`` where C % 64 == 32
    and C >= 160 (the same 64-channel boxes, ceil(C / 64) a tap, the last
    one's upper 32 channels read as zero; W repacked to 64 ceil(C / 64)
    channels), ``"im2col32"`` for the other C % 64 == 32 (C = 32 and 96:
    the 32 channels of one tap in 64-byte rows), else ``"im2col16"`` (boxes of
    16 channels of one tap, ``CONV_BF16_BOXES`` a stage, channels past C
    read as zero; W repacked in box order, its N-tile resident beside the
    ring where :func:`conv_bf16_ring` fits it), except a 3x3 pad-1
    stride-1 conv with C % 16 == 8 and at most ``CONV_BF16_HALO_OUT``
    outputs that :func:`conv_bf16_halo` fits (``"halo"``: a 4 x 32 block of
    output pixels a tile from one box of its input pixels, A built by
    ldmatrix; measured faster than the 16-channel boxes at p7's 768^2 40 ->
    40, whose 32-byte rows straddle the sectors of 80-byte pixels: PERF.md
    section 6); else (more boxes than the table holds, or W too large to
    stay resident) by the 16-byte gather (``"gather"``).
    Off the packed route C is padded with zero channels to a multiple of 8
    (TMA's rows and the gather's copies are 16 bytes).  The block tile is
    BN = 64 output columns up to 64 outputs, else 128; on ``"im2col16"`` and
    ``"halo"`` the tile of ``CONV_BF16_BOX_BN`` that leaves the fewest zero
    columns (40 -> 48, 80 -> 80, 160 -> 2 x 80); on ``"im2col_pad"`` where O
    is a multiple of 2 ``CONV_BF16_PAIR_BN`` (160, 320, 480) a tile of
    ``CONV_BF16_PAIR_BN``, the cluster's two CTAs on one M-tile, each
    loading half of A's rows for both.  Those choices follow the card
    (``tools/profile_torch_step.py --k5-pad``, PERF.md section 6): against
    one tap's 32 channels a stage, the 64-channel boxes ran yolov4x-mish's
    and yolov4-p7's C = 160 / 480 convs 4-13 % faster at the same tiles
    and 1.15-2.03x faster on the paired 80-column tiles (which beat the
    128-column ones by 2 % at 480 -> 480, 11-79 % at O = 160 / 320); at C
    = 96 a box half past C gained at 96 -> 192 and lost at 96 -> 128
    (0.6311 against 0.5876 ms), and the paired tile lost wherever O is no
    multiple of 160."""
    bn, cp = 64 if out_channels <= 64 else 128, -(-channels // 8) * 8
    if kh == kw == 1 and stride == 1 and pad == 0:
        return "tma", bn, cp
    if kh == kw == 3 and channels == 3 and out_channels <= CONV_BF16_PACKED_BN[-1]:
        return "packed", next(n for n in CONV_BF16_PACKED_BN if n >= out_channels), channels
    if cp % 64 == 0 and kh * kw * cp // 64 <= CONV_BF16_MAX_STAGES:
        return "im2col", bn, cp
    if cp % 64 == 32 and cp >= 160 and kh * kw * -(-cp // 64) <= CONV_BF16_MAX_STAGES:
        pair = out_channels % (2 * CONV_BF16_PAIR_BN) == 0
        return "im2col_pad", CONV_BF16_PAIR_BN if pair else bn, cp
    if cp % 64 == 32 and kh * kw * cp // 32 <= CONV_BF16_MAX_STAGES:
        return "im2col32", bn, cp
    boxes = kh * kw * -(-cp // _stage_k("im2col16"))
    bn16 = min(CONV_BF16_BOX_BN, key=lambda n: (-(-out_channels // n) * n, -n))
    if (kh == kw == 3 and pad == 1 and stride == 1 and cp % 16 == 8
            and out_channels <= CONV_BF16_HALO_OUT and conv_bf16_halo(cp, bn16) is not None):
        return "halo", bn16, cp
    if boxes <= CONV_BF16_MAX_STAGES and conv_bf16_ring(bn16, -(-boxes // CONV_BF16_BOXES)):
        return "im2col16", bn16, cp
    return "gather", bn, cp


def _stage_k(route: str) -> int:
    """bf16 of K an entry of K5's stage table on ``route`` (a box): 32 on
    ``"im2col32"`` and ``"packed"``, 16 on ``"im2col16"`` (whose stage holds
    ``CONV_BF16_BOXES`` boxes), else 64 (one 128-byte row; on
    ``"im2col_pad"`` a tap's last box half past C)."""
    return {"im2col32": 32, "packed": 32, "im2col16": 16}.get(route, CONV_BF16_STAGE_K)


class Im2colPlan(NamedTuple):
    """The TMA im2col map of K5's ``"im2col"`` route (``csrc/conv_bf16.cuh:
    encode_im2col``): the pixel box's corners, (W, H) offsets from x's
    first and last pixel, and the traversal's (W, H) strides.  The box spans
    pixels ``lower .. size - 1 + upper`` of each spatial dimension: the
    top-left input pixel of every output's window."""
    lower: tuple[int, int]
    upper: tuple[int, int]
    strides: tuple[int, int]


def conv_bf16_im2col(kh: int, kw: int, stride: int, pad: int) -> Im2colPlan:
    """K5's im2col map for a conv with Darknet's padding ``pad`` on each
    side: the lower corner is ``-pad``, the upper ``pad - (k - 1)``, so the
    box walked at ``stride`` meets each output pixel once, in NHWC order."""
    return Im2colPlan((-pad, -pad), (pad - (kw - 1), pad - (kh - 1)), (stride, stride))


def conv_bf16_stages(route: str, channels: int, kh: int, kw: int) -> list[tuple[int, int, int]]:
    """The boxes of K of an im2col ``route``, in order: ``(first channel, W
    offset, H offset)`` of each, the tap (r, q) and a slice of
    ``_stage_k(route)`` channels, K's flat (tap, channel) order (on
    ``"im2col16"`` and ``"im2col_pad"`` the last box of a tap may run past
    C: those channels read as zero, and W has zero channels there,
    :func:`conv_bf16_weights`).
    The wrapper passes them to the kernel (``ConvBf16Args.stage_tab``)."""
    return [(c0, q, r) for r in range(kh) for q in range(kw)
            for c0 in range(0, channels, _stage_k(route))]


def _conv_bf16_args(x_shape: tuple[int, ...], w_shape: tuple[int, ...], stride: int, pad: int,
                    act: str, route: str, ptrs: tuple = (None,) * 5) -> _ConvBf16Args:
    """K5's C arguments for NHWC ``x_shape`` (C already padded to the plan's)
    and (O, KH, KW, C) ``w_shape`` on ``route``: the shapes, and on the
    im2col routes the box corners of :func:`conv_bf16_im2col` and the stage
    table of :func:`conv_bf16_stages`.  ``ptrs``: x, w, bias, shortcut, out."""
    n, h, w, c = x_shape
    o, kh, kw, _ = w_shape
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    args = _ConvBf16Args(*ptrs, n, h, w, c, ho, wo, o, kh, kw, stride, pad, n * ho * wo, _ACT[act])
    if route in ("im2col", "im2col32", "im2col16", "im2col_pad"):
        box = conv_bf16_im2col(kh, kw, stride, pad)
        args.lo_w, args.lo_h = box.lower
        args.hi_w, args.hi_h = box.upper
        stages = conv_bf16_stages(route, c, kh, kw)
        args.stages = len(stages)
        args.stage_tab[:len(stages)] = [c0 | q << 16 | r << 24 for c0, q, r in stages]
    return args


_PADDED_W: dict = {}  # (id(w), width) -> (weakref to w, w._version, w padded)


def conv_bf16_weights(w: torch.Tensor, route: str, cp: int) -> torch.Tensor:
    """(O, KH, KW, C) ``w`` as K5 reads it on ``route`` with x padded to
    ``cp`` channels: zero channels up to ``cp``, on ``"im2col16"`` and
    ``"halo"`` up to 16 ceil(cp / 16), on ``"im2col_pad"`` up to 64 ceil(cp
    / 64) (box order: each box's channels past C are zero).  ``w`` itself
    where nothing is added; else made once a weight tensor and width and
    kept while ``w`` lives and is not written to, so a conv does not pad its
    weights every call."""
    box = {"im2col16": 16, "halo": 16, "im2col_pad": 64}.get(route)
    width = -(-cp // box) * box if box else cp
    if width == w.shape[3]:
        return w
    key = (id(w), width)
    hit = _PADDED_W.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    padded = F.pad(w, (0, width - w.shape[3])).contiguous()
    _PADDED_W[key] = (weakref.ref(w, lambda _, k=key: _PADDED_W.pop(k, None)), w._version,
                      padded)
    return padded


class HaloPlan(NamedTuple):
    """K5's halo route for a conv (``csrc/conv_bf16_halo.cu: halo_layout``): a
    halo pixel's channels (C, then zeros), the halo's pixels a row and
    rows, 16-channel blocks a tap, W's 64-wide K chunks, a halo buffer's
    bytes and the block's shared memory."""
    cp: int
    hw: int
    hr: int
    nb: int
    ksteps: int
    halo_bytes: int
    smem: int


def conv_bf16_halo(channels: int, bn: int) -> "HaloPlan | None":
    """The halo route's geometry for a 3x3 pad-1 stride-1 conv of
    ``channels`` (a multiple of 8) with a ``bn``-column tile of 32 or 48, or
    None where two halo buffers, W and the epilogue's staging do not fit in
    a block's shared memory, or BN is another width (the route is built for
    those two only).  A halo pixel holds an odd number of 16-byte pieces, so
    that the 8 rows of an ldmatrix phase (neighbouring pixels) fall in 8
    bank groups."""
    th, tw = CONV_BF16_HALO_TILE
    nb = -(-channels // 16)
    cp = 16 * nb + 8
    hw, hr = tw + 2, th + 2
    ksteps = -(-9 * nb // CONV_BF16_BOXES)
    halo = -(-cp * hw * hr * 2 // 1024) * 1024
    smem = ksteps * bn * 128 + 2 * halo + 2 * 64 * 160 + 2 * bn * 4 + 8 * 5 + 1024
    fits = smem <= CONV_BF16_SMEM and cp <= 256 and bn in (32, 48)
    return HaloPlan(cp, hw, hr, nb, ksteps, halo, smem) if fits else None


def conv_bf16_ring(bn: int, ksteps: int) -> int:
    """A stages of K5's "im2col16" ring beside W's N-tile held in shared
    memory (``csrc/conv_bf16.cu: resident_layout``): as many as fit, up to
    ``CONV_BF16_RING[1]``; 0 where fewer than ``CONV_BF16_RING[0]`` fit (the
    plan then sends the conv to the gather).  W's N-tile is ``ksteps``
    chunks of BN rows x 128 bytes."""
    lo, hi = CONV_BF16_RING
    fixed = 2 * 64 * 160 + 2 * bn * 4 + CONV_BF16_TILE_M * 16 + 8 * (2 * hi + 1)
    ring = (CONV_BF16_SMEM - 1024 - ksteps * bn * 128 - fixed) // (
        CONV_BF16_TILE_M * 32 * CONV_BF16_BOXES)
    return min(ring, hi) if ring >= lo else 0


def conv_bf16_traffic(x_shape: tuple[int, ...], w_shape: tuple[int, ...], stride: int,
                      pad: int) -> tuple[int, int, int]:
    """(block tiles, stages of K a tile, tile-load bytes) of one K5 launch,
    modelled from the shapes (no counter is read): the tiles of a cluster's
    pairs of M-tiles (``csrc/conv_bf16.cu``: an odd M-tile count runs one
    tile past M), and the bytes their loads bring into shared memory, each
    stage a 128-row A box and half of the BN-row B box, which the TMA unit
    multicasts to both CTAs; rows of 128 bytes (64 on ``"im2col32"``; on
    ``"im2col_pad"`` ceil(C / 64) boxes a tap, the last half past C, and at
    BN = ``CONV_BF16_PAIR_BN`` the cluster's two tiles share one M-tile:
    each CTA loads half of A's rows for both and its own BN-row B; on
    ``"im2col16"`` A is ``CONV_BF16_BOXES`` boxes of 32-byte rows a stage,
    fewer in the last, and each of at most ``CONV_BF16_SMS`` blocks loads
    W's resident N-tile once instead).  The halo route: 4 x 32-pixel tiles,
    one halo box each (``conv_bf16_halo``), W's ``ksteps`` 64-wide K chunks,
    loaded once a block.  The packed
    route: 256-pixel tiles of one stage, its A rows (64 bytes) built from
    x."""
    n, h, w, c = x_shape
    o, kh, kw, _ = w_shape
    route, bn, cp = conv_bf16_plan(c, o, kh, kw, stride, pad)
    m = n * ((h + 2 * pad - kh) // stride + 1) * ((w + 2 * pad - kw) // stride + 1)
    if route == "packed":
        tiles = -(-m // CONV_BF16_PACKED_ROWS)
        return tiles, 1, tiles * CONV_BF16_PACKED_ROWS * 2 * CONV_BF16_PACKED_K
    stage_k = _stage_k(route)
    tiles = -(-m // (2 * CONV_BF16_TILE_M)) * 2 * -(-o // bn)
    if route == "halo":  # a halo box a 4 x 32 tile (stride 1), W once a block
        th, tw = CONV_BF16_HALO_TILE
        hp = conv_bf16_halo(cp, bn)
        tiles = n * -(-h // th) * -(-w // tw)
        return tiles, hp.ksteps, (tiles * hp.cp * hp.hw * hp.hr * 2
                                  + min(tiles, CONV_BF16_SMS) * hp.ksteps * bn * 128)
    if route == "im2col16":
        boxes = kh * kw * -(-cp // stage_k)
        ksteps = -(-boxes // CONV_BF16_BOXES)
        return tiles, ksteps, (tiles * boxes * CONV_BF16_TILE_M * 32
                               + min(tiles, CONV_BF16_SMS) * ksteps * bn * 128)
    ksteps = kh * kw * -(-cp // stage_k) if route == "im2col_pad" else -(-kh * kw * cp // stage_k)
    if route == "im2col_pad" and bn == CONV_BF16_PAIR_BN:
        tiles = -(-m // CONV_BF16_TILE_M) * 2 * -(-o // (2 * bn))
        return tiles, ksteps, tiles * ksteps * 2 * stage_k * (CONV_BF16_TILE_M // 2 + bn)
    return tiles, ksteps, tiles * ksteps * 2 * stage_k * (CONV_BF16_TILE_M + bn // 2)


def conv_bf16_work(x_shape: tuple[int, ...], w_shape: tuple[int, ...], stride: int, pad: int,
                   shortcut: bool = False) -> tuple[int, int]:
    """(bf16 flops, bytes) of one K5 call: ``2 * M * O * KH * KW * C``, and
    the NHWC bf16 input, the bf16 weights, the fp32 bias, the bf16 output
    (and shortcut) each counted once."""
    n, h, w, c = x_shape
    o, kh, kw, _ = w_shape
    m = n * ((h + 2 * pad - kh) // stride + 1) * ((w + 2 * pad - kw) // stride + 1)
    return (2 * m * o * kh * kw * c,
            2 * n * h * w * c + 2 * o * kh * kw * c + 4 * o + 2 * m * o * (2 if shortcut else 1))


def conv_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int, pad: int,
              act: str = "linear", shortcut: "torch.Tensor | None" = None,
              _route: "str | None" = None, _bn: "int | None" = None) -> torch.Tensor:
    """K5: NHWC bf16 ``x`` (N, H, W, C) conv (O, KH, KW, C) bf16 ``w``, zero
    padding ``pad`` on each side, + (O,) fp32 bias ``b``, activation
    ``act`` in fp32 -> NHWC bf16 (N, Ho, Wo, O), rounded once; ``shortcut``
    (N, Ho, Wo, O) bf16 is then added as a bf16 add (a Darknet
    [shortcut] whose first operand is this conv).  A CPU tensor takes
    :func:`conv_bf16_ref`; a CUDA tensor launches the kernel or raises.
    ``_route`` runs another route than the plan's, for A/B timings:
    ``"gather"`` (the 16-byte gather with BN = 64 / 128, as before the
    packed and "im2col16" routes took C % 32 != 0), ``"im2col16"`` (on a
    conv the plan gives the halo route) or ``"im2col32"`` (32 channels a
    stage, BN = 64 / 128, on a conv the plan gives ``"im2col_pad"``, as
    before that route); ``_bn`` another tile of ``"im2col_pad"`` (64 / 128,
    or ``CONV_BF16_PAIR_BN``)."""
    if x.dim() != 4 or w.dim() != 4 or x.shape[3] != w.shape[3]:
        raise ValueError(f"conv_bf16: (N, H, W, C) and (O, KH, KW, C) expected, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, c = x.shape
    o, kh, kw, _ = w.shape
    ho, wo = (h + 2 * pad - kh) // stride + 1, (wd + 2 * pad - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"conv_bf16: empty output for {tuple(x.shape)} with a {kh}x{kw} "
                         f"kernel, stride {stride}, pad {pad}")
    if tuple(b.shape) != (o,) or b.dtype != torch.float32:
        raise ValueError(f"conv_bf16: b must be ({o},) float32")
    if act not in _ACT:
        raise ValueError(f"conv_bf16: unknown activation {act!r}")
    if shortcut is not None and tuple(shortcut.shape) != (n, ho, wo, o):
        raise ValueError(f"conv_bf16: shortcut must be ({n}, {ho}, {wo}, {o})")
    if x.device.type == "cpu":
        return conv_bf16_ref(x, w, b, stride, pad, act, shortcut)

    for t, what in ((x, "x"), (w, "w"), (shortcut, "shortcut")):
        if t is not None and t.dtype != torch.bfloat16:
            raise ValueError(f"conv_bf16: {what} must be bfloat16, got {t.dtype}")
    route, bn, cp = conv_bf16_plan(c, o, kh, kw, stride, pad)
    if _route == "gather":
        route, bn, cp = "gather", 64 if o <= 64 else 128, -(-c // 8) * 8
    elif _route is not None:
        if (_route, route) not in (("im2col16", "halo"), ("im2col32", "im2col_pad")):
            raise ValueError(f"conv_bf16: no {_route!r} route for this conv (plan {route!r})")
        route, bn = _route, bn if _route == "im2col16" else 64 if o <= 64 else 128
    if _bn is not None:
        if route != "im2col_pad" or _bn not in (64 if o <= 64 else 128, CONV_BF16_PAIR_BN):
            raise ValueError(f"conv_bf16: no {_bn}-column tile on route {route!r}")
        bn = _bn
    if cp != c:  # zero channels: TMA's rows and the gather's copies are 16 bytes
        x = F.pad(x, (0, cp - c))
    x, w = _on_grid(x), _on_grid(conv_bf16_weights(w, route, cp))
    if shortcut is not None:
        shortcut = _on_grid(shortcut)
    device, stream = _cuda_args("conv_bf16", x, w, b, shortcut)
    out = torch.empty((n, ho, wo, o), dtype=torch.bfloat16, device=x.device)
    ptrs = tuple(None if t is None else t.data_ptr() for t in (x, w, b, shortcut, out))
    args = _conv_bf16_args(tuple(x.shape), (o, kh, kw, cp), stride, pad, act, route, ptrs)
    _launch("conv_bf16", load_library().yolo_conv_bf16, ctypes.byref(args), bn,
            CONV_BF16_ROUTES[route], device, stream)
    CONV_BF16_LAUNCHES[route] += 1
    return out


# ---------------------------------------------------------------------------
# K6: the int8 input quantizer and the dynamic scale
# ---------------------------------------------------------------------------

MAX_QUANT_BRANCHES = 8  # csrc/quantize_i8.cu: kMaxBranches


class _QuantBranch(ctypes.Structure):
    """csrc/quantize_i8.cu: QuantBranch, field for field."""

    _fields_ = ([("x", ctypes.c_void_p), ("scale", ctypes.c_void_p)]
                + [(n, ctypes.c_longlong) for n in ("rows", "vecs", "first_tile")]
                + [(n, ctypes.c_int) for n in ("channels", "row_stride", "out_offset",
                                                "elem_bytes", "scale_vec", "mode")])


class _QuantArgs(ctypes.Structure):
    """csrc/quantize_i8.cu: QuantArgs, field for field."""

    _fields_ = [("b", _QuantBranch * MAX_QUANT_BRANCHES), ("out", ctypes.c_void_p),
                ("tiles", ctypes.c_longlong), ("branches", ctypes.c_int),
                ("out_channels", ctypes.c_int)]


def _branches(name: str, x) -> list:
    """``x`` as a list of branches: a tensor, or the sources of a concat
    along the last axis (1 to MAX_QUANT_BRANCHES of them)."""
    xs = list(x) if isinstance(x, (list, tuple)) else [x]
    if not 1 <= len(xs) <= MAX_QUANT_BRANCHES:
        raise ValueError(f"{name}: 1..{MAX_QUANT_BRANCHES} branches, got {len(xs)}")
    return xs


def _branch_scales(xs: list, sx) -> list:
    """One scale a branch: ``sx`` a 0-d scale for every branch, a (C,)
    per-channel vector over the concatenation (each branch its slice), or a
    sequence of one 0-d or (C_g,) scale a branch."""
    widths = [t.shape[-1] for t in xs]
    if isinstance(sx, (list, tuple)):
        scales = list(sx)
    elif sx.dim() == 0:
        scales = [sx] * len(xs)
    elif sx.dim() == 1 and sx.shape[0] == sum(widths):
        offs = itertools.accumulate(widths, initial=0)
        scales = [sx[o:o + c] for o, c in zip(offs, widths)]
    else:
        scales = None
    if scales is None or len(scales) != len(xs) or any(
            s.dim() > 1 or (s.dim() == 1 and s.shape[0] != c) for s, c in zip(scales, widths)):
        shape = tuple(sx.shape) if isinstance(sx, torch.Tensor) else [tuple(s.shape) for s in sx]
        raise ValueError(f"quantize_i8: sx must be 0-d, ({sum(widths)},) or one 0-d or (C_g,) "
                         f"scale a branch of widths {widths}, got {shape}")
    return scales


def _rows_view(t: torch.Tensor) -> "tuple[torch.Tensor, int, int, int]":
    """(t or a contiguous copy of it, rows, channels, row stride) of a
    (..., C) branch: one whose rows of C unit-stride elements sit one stride
    apart (a contiguous tensor, or a channel slice of one) is read in
    place."""
    c = t.shape[-1]
    rows = t.numel() // c if c else 0
    if t.is_contiguous() or (rows <= 1 and (c <= 1 or t.stride(-1) == 1)):
        return t, rows, c, c
    stride = expect = None
    if c == 1 or t.stride(-1) == 1:
        for d in range(t.dim() - 2, -1, -1):
            if t.shape[d] == 1:
                continue
            if expect is None:
                stride = expect = t.stride(d)
            if t.stride(d) != expect:
                stride = None
                break
            expect = t.stride(d) * t.shape[d]
    if stride is not None and stride >= c:
        return t, rows, c, stride
    return t.contiguous(), rows, c, c


def _quant_args(views: list, scales: "list | None", out: torch.Tensor,
                out_channels: int) -> _QuantArgs:
    """K6's launch arguments for branches ``views`` ((tensor, rows,
    channels, row stride), as :func:`_rows_view` gives them), their scales
    (None: ``absmax``) and the output.  Built
    positionally: a launch a conv input, on the batch-1 host path too."""
    branches, off = [], 0
    for g, (t, rows, c, stride) in enumerate(views):
        s = None if scales is None else scales[g]
        branches.append(_QuantBranch(t.data_ptr(), None if s is None else s.data_ptr(), rows, 0,
                                     0, c, stride, off, t.element_size(),
                                     int(s is not None and s.dim() == 1), 0))
        off += c
    return _QuantArgs((_QuantBranch * MAX_QUANT_BRANCHES)(*branches), out.data_ptr(), 0,
                      len(views), out_channels)


def _k6_inputs(name: str, xs: list) -> None:
    for t in xs:
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: branches must be float32 or bfloat16, got {t.dtype}")
        if t.numel() >= 1 << 32 and not t.is_contiguous():
            raise ValueError(f"{name}: a strided branch must hold fewer than 2^32 elements")


def quantize_i8_ref(x, sx) -> torch.Tensor:
    """Plain torch version of K6's quantizer (arguments: :func:`quantize_i8`):
    each branch widened to fp32, divided by its scale, rounded half to even,
    clamped to [-127, 127], cast to int8, and the branches concatenated
    along the last axis (``pytorch_yolo_tpu/ops/quant.py:573-596``)."""
    xs = _branches("quantize_i8", x)
    parts = [torch.clamp(torch.round(t.to(torch.float32) / s), -127, 127).to(torch.int8)
             for t, s in zip(xs, _branch_scales(xs, sx))]
    return parts[0] if len(parts) == 1 else torch.cat(parts, -1)


def quantize_i8(x, sx) -> torch.Tensor:
    """K6: bf16 or fp32 ``x`` (..., C) -> int8 ``clamp(round(x / sx), -127,
    127)``.  ``x`` may be the sources of a concat along the last axis (a
    list of (..., C_g) branches, each bf16 or fp32, equal in their leading
    dims): the int8 of their concatenation is written directly, with no
    concatenated copy.  ``sx``: an fp32 0-d scale, a (C,) per-channel
    vector, or one 0-d (or (C_g,)) scale a branch (a split concat's branch
    scales).  One launch; a branch is read in place when its rows sit one
    stride apart (a channel slice is), else copied first.  A CPU tensor
    takes :func:`quantize_i8_ref`; a CUDA tensor launches the kernel or raises."""
    xs = [x] if isinstance(x, torch.Tensor) else _branches("quantize_i8", x)
    scales = ([sx] if len(xs) == 1 and isinstance(sx, torch.Tensor) and sx.dim() == 0
              else _branch_scales(xs, sx))
    lead = xs[0].shape[:-1]
    if xs[0].dim() == 0 or any(t.dim() == 0 or t.shape[:-1] != lead for t in xs[1:]):
        raise ValueError(f"quantize_i8: branches {[tuple(t.shape) for t in xs]} must share "
                         "their leading dims")
    if xs[0].device.type == "cpu":
        return quantize_i8_ref(xs, scales)
    _k6_inputs("quantize_i8", xs)
    if any(s.dtype != torch.float32 for s in scales):
        raise ValueError("quantize_i8: scales must be float32")
    device, stream = _cuda_device("quantize_i8", *xs, *scales)
    scales = [s.contiguous() for s in scales]
    c = sum(t.shape[-1] for t in xs)
    out = torch.empty((*lead, c), dtype=torch.int8, device=xs[0].device)
    if out.numel():
        args = _quant_args([_rows_view(t) for t in xs], scales, out, c)
        _launch("quantize_i8", load_library().yolo_quantize_i8, ctypes.byref(args), device,
                stream)
    return out


def absmax_ref(x, scale: bool = False) -> torch.Tensor:
    """Plain torch version of K6's reduction (arguments: :func:`absmax`):
    ``max|x|`` over every branch as a 0-d fp32, or with ``scale`` the
    dynamic scale built on it (``ops/quant.py: scale_of_amax``)."""
    from .quant import scale_of_amax  # quant imports this module

    xs = _branches("absmax", x)
    m = torch.stack([t.abs().amax().to(torch.float32) for t in xs]).amax()
    return scale_of_amax(m) if scale else m


def _absmax_views(xs: list) -> list:
    """``absmax``'s branches as :func:`_quant_args` takes them: a tensor in
    a dense layout (contiguous or channels_last) as one flat run of its
    elements in memory order, any other as :func:`_rows_view` gives it."""
    return [(t, t.numel(), 1, 1) if t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last)) else _rows_view(t)
        for t in xs]


def absmax(x, scale: bool = False) -> torch.Tensor:
    """K6's reduction: ``max|x|`` of a bf16 or fp32 tensor (or of the
    branches of a concat, or of any tensors) as a 0-d fp32 on its device,
    exact (the max and the widening commute); with ``scale`` the dynamic
    int8 scale ``fma(max, 1/127, eps)`` instead, written by the same launch
    (the bits of ``ops/quant.py: scale_of_amax``).  A tensor in a dense
    layout (contiguous or channels_last) or a channel slice is read in
    place.  A CPU tensor takes :func:`absmax_ref`; a CUDA tensor launches
    the kernel or raises."""
    xs = [x] if isinstance(x, torch.Tensor) else _branches("absmax", x)
    if xs[0].device.type == "cpu":
        return absmax_ref(xs, scale)
    _k6_inputs("absmax", xs)
    device, stream = _cuda_device("absmax", *xs)
    out = torch.empty(3, dtype=torch.float32, device=xs[0].device)  # max, scale, ticket
    args = _quant_args(_absmax_views(xs), None, out, 1)
    _launch("absmax", load_library().yolo_absmax, ctypes.byref(args), device, stream)
    return out[1] if scale else out[0]

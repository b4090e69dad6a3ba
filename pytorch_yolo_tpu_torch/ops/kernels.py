"""The hand-written CUDA kernels, their plain versions, and their build.

* **K1** :func:`decode_score_all` / :func:`decode_score_head`
  (``csrc/decode_score.cu``): every head's raw map, bf16 or fp32, -> one
  (N, D, 8) buffer of rows ``[x1, y1, x2, y2, obj, cls_score, cls_id,
  rank]`` in one launch (``pytorch_yolo_tpu/ops/pallas_kernels.py:
  decode_score_head``); :func:`decode_plan` is its launch table.
* **K2** :func:`nms_keep` (``csrc/nms_keep.cu``): batched greedy-NMS keep
  mask, the overlap bitmask built by the whole block and scanned by one
  warp (``pallas_kernels.py: nms_keep_pallas``).
* **K3** :func:`int8_gemm` (``csrc/gemm_i8.cu``): s8 x s8 -> s32 GEMM with
  the probe's fixed-point requant (``tools/int8_kernel_probe.py:
  gemm_i8_pallas``) or the int8 serving epilogue; every quantized 1x1
  stride-1 conv.
* **K4** :func:`int8_conv` (``csrc/int8_conv.cu``): int8 implicit-GEMM conv
  with the serving epilogue (``pytorch_yolo_tpu/ops/quant.py:
  quantized_conv``); every other quantized conv.

K3 and K4 run on the Hopper core ``csrc/int8_wgmma.cuh`` (wgmma, TMA, a
warp-specialised ring, persistent blocks) whenever C and the group offsets
are multiples of 16 (:func:`igemm_plan`); the ``mma.sync`` core
``csrc/int8_igemm.cuh`` keeps the byte path, counted apart as
``int8_gemm_mma`` / ``int8_conv_mma``.

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
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..config import ModelSpec, head_strides
from .decode import head_decode_args

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = tuple(os.path.join(CSRC, f) for f in
                ("decode_score.cu", "nms_keep.cu", "gemm_i8.cu", "int8_conv.cu"))
HEADERS = tuple(os.path.join(CSRC, f) for f in ("int8_igemm.cuh", "int8_wgmma.cuh"))
BUILD_DIR = os.path.join(CSRC, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libyolo_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"decode_score": 0, "nms_keep": 0, "int8_gemm": 0, "int8_gemm_mma": 0,
            "int8_conv": 0, "int8_conv_mma": 0}

MAX_ANCHORS = 8         # csrc/decode_score.cu: kMaxAnchors
MAX_HEADS = 8           # csrc/decode_score.cu: kMaxHeads, heads in one K1 launch
DECODE_TILE_ROWS = 128  # csrc/decode_score.cu: kTileRows, rows a K1 tile
MAX_NMS_K = 1024        # csrc/nms_keep.cu: kMaxK, one bitmask word a lane
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
            lib.yolo_nms_keep.argtypes = [p, p, p, p, i, i, ctypes.c_float, i, p]
            for fn in (lib.yolo_decode_score, lib.yolo_nms_keep):
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


def _cuda_args(name: str, *tensors: "torch.Tensor | None") -> tuple[int, int]:
    """Check that every tensor is a contiguous tensor on one CUDA device;
    returns (device index, current stream handle)."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    _check_hopper(dev.index)
    return dev.index, torch.cuda.current_stream(dev).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


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
    rc = load_library().yolo_decode_score(ctypes.byref(args), heads[0].element_size(), device,
                                          stream)
    _raise_on(rc, "decode_score")
    LAUNCHES["decode_score"] += 1


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


def nms_keep(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
             cls_id: "torch.Tensor | None" = None) -> torch.Tensor:
    """K2: (N, K, 4) score-sorted corner boxes, (N, K) bool valid, optional
    (N, K) fp32 class ids (class-wise suppression) -> (N, K) bool keep mask."""
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
    if not 1 <= k <= MAX_NMS_K:
        raise ValueError(f"nms_keep: K={k}, the kernel takes 1..{MAX_NMS_K}")
    device, stream = _cuda_args("nms_keep", boxes, valid, cls_id)
    if boxes.data_ptr() % 16:
        raise ValueError("nms_keep: boxes must be 16-byte aligned")
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    rc = load_library().yolo_nms_keep(
        boxes.data_ptr(), valid.data_ptr(), None if cls_id is None else cls_id.data_ptr(),
        keep.data_ptr(), n, k, float(iou_thresh), device, stream)
    _raise_on(rc, "nms_keep")
    LAUNCHES["nms_keep"] += 1
    return keep


# ---------------------------------------------------------------------------
# K3 and K4: int8 GEMM and int8 implicit-GEMM conv
# ---------------------------------------------------------------------------

MAX_SPLIT_GROUPS = 4  # csrc/int8_igemm.cuh: kMaxGroups
_ACT = {"linear": 0, "leaky": 1, "mish": 2, "relu": 3, "logistic": 4}
_EPI_ACC, _EPI_FIXED, _EPI_F32, _EPI_I8 = 0, 1, 2, 3
_HOMOGENEOUS = ("leaky", "relu", "linear")  # act(y / s) == act(y) / s for s > 0


class _IgemmArgs(ctypes.Structure):
    """csrc/int8_igemm.cuh: IgemmArgs, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in
                 ("x", "w", "out", "sx", "sxg", "ws", "bias", "out_scale")]
                + [(n, ctypes.c_int) for n in
                   ("batch", "H", "W", "C", "Ho", "Wo", "O", "KH", "KW", "stride", "pad", "M",
                    "groups")]
                + [("goff", ctypes.c_int * (MAX_SPLIT_GROUPS + 1))]
                + [(n, ctypes.c_int) for n in ("mode", "act", "out_scale_vec", "pre", "mul", "sh")])


def _requant_fixed(acc: torch.Tensor, pre: int, m: int, sh: int) -> torch.Tensor:
    """The probe's fixed-point requant on int32 (``>>`` is an arithmetic shift,
    as XLA's is): ``clip(acc > 0 ? ((acc>>pre)*m)>>sh : ((acc>>pre)*m)>>(sh+3), ±127)``."""
    scaled = (acc >> pre) * m
    y = torch.where(acc > 0, scaled >> sh, scaled >> (sh + 3))
    return torch.clamp(y, -127, 127).to(torch.int8)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, as CUDA's ``__fmaf_rn`` and as the
    JAX package's compiled epilogue (XLA contracts its multiply-adds).  The
    product is exact in float64 (24 + 24 bits); the float64 sum is rounded
    to odd (TwoSum gives its error), which makes the final rounding to fp32
    the correct one (Boldo & Melquiond, "Emulation of FMA and correctly
    rounded sums", 2008)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    return torch.where((err != 0) & even, torch.nextafter(s, away), s).float()


def _serving_epilogue(v: torch.Tensor, ws: torch.Tensor, b: torch.Tensor, activation: str,
                      sx: "torch.Tensor | None", out_scale: "torch.Tensor | None") -> torch.Tensor:
    """``pytorch_yolo_tpu/ops/quant.py:600-622`` on an fp32 (..., O) sum:
    dequant (``sx * ws``, or ``ws`` alone when ``sx`` is None or a per-channel
    grid), bias, activation; with ``out_scale``, int8 at that scale (leaky,
    relu and linear divide first and activate after, the others activate at
    the true scale, then divide).  ``sum * deq + bias`` is one fused
    multiply-add, as XLA compiles it."""
    from ..models.darknet import apply_activation  # darknet imports this module

    deq = ws if sx is None or sx.dim() == 1 else sx * ws
    if out_scale is None:
        return apply_activation(fma(v, deq, b), activation)
    if activation in _HOMOGENEOUS:
        y = apply_activation(fma(v, deq / out_scale, b / out_scale), activation)
    else:
        y = apply_activation(fma(v, deq, b), activation) / out_scale
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
                  splits=None) -> torch.Tensor:
    """The kernels' epilogue in plain torch (arguments: :func:`int8_gemm`);
    ``acc_of(lo, hi)`` gives the int32 accumulators over input channels
    [lo, hi)."""
    if sxg is not None:  # split concat: per-branch int32 sums, merged in fp32
        bounds = [0, *itertools.accumulate(splits)]
        parts = [acc_of(lo, hi).to(torch.float32) for lo, hi in zip(bounds, bounds[1:])]
        return _serving_epilogue(_split_sum(parts, sxg), ws, b, activation, None, out_scale)
    acc = acc_of(0, channels)
    if accumulators:
        return acc
    if fixed is not None:
        return _requant_fixed(acc, *fixed)
    return _serving_epilogue(acc.to(torch.float32), ws, b, activation, sx, out_scale)


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
               aligned: bool) -> tuple[str, int]:
    """The K3/K4 core for a call, from its shapes alone: ``("wgmma", BN)``
    with a BN-column tile when the channel count and every group offset are
    multiples of 16 and both operands are 16-byte aligned (what TMA and the
    16-byte gather need); BN is 256 from 256 output channels on, 128 below
    and for split groups (their fp32 group sums double the accumulators).
    Else ``("mma", 128)``: the ``mma.sync`` core's byte path, which an int8
    RGB stem takes (C = 3)."""
    if aligned and channels % 16 == 0 and all(g % 16 == 0 for g in goff):
        return "wgmma", 128 if split or out_channels < 256 else 256
    return "mma", 128


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


def _igemm(name: str, xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int,
           out_shape: tuple[int, ...], *, fixed=None, accumulators=False, ws=None, b=None,
           activation="linear", sx=None, out_scale=None, sxg=None, splits=None,
           _mma: bool = False) -> torch.Tensor:
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
    scalar = [t for t in (sx, out_scale) if t is not None and t.dim() == 0]
    device, stream = _cuda_args(name, xq, wq, ws, b, sxg, *scalar,
                                *[t for t in (sx, out_scale) if t is not None and t.dim() == 1])
    out = torch.empty(out_shape, dtype=out_dtype, device=xq.device)
    aligned = xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    core, bn = igemm_plan(c, goff, o, sxg is not None, aligned)
    if _mma or core == "mma":
        # the mma.sync entry takes its 16-byte-copy flag, which needs what wgmma needs
        key, arg = name + "_mma", int(core == "wgmma")
    else:  # the wgmma entry takes the tile width
        key, arg = name, bn
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    pre, mul, sh = fixed if fixed is not None else (0, 0, 0)
    m = out.numel() // o
    args = _IgemmArgs(
        ptr(xq), ptr(wq), ptr(out), ptr(sx) if sx is not None and sx.dim() == 0 else None,
        ptr(sxg), ptr(ws), ptr(b), ptr(out_scale),
        n, h, w, c, out_shape[1] if len(out_shape) == 4 else 1,
        out_shape[2] if len(out_shape) == 4 else 1, o, kh, kw, stride, pad, m, len(goff) - 1,
        (ctypes.c_int * (MAX_SPLIT_GROUPS + 1))(*goff), mode, _ACT[activation],
        int(out_scale is not None and out_scale.dim() == 1), pre, mul, sh)
    fn = getattr(load_library(), "yolo_" + key)
    _raise_on(fn(ctypes.byref(args), arg, device, stream), key)
    LAUNCHES[key] += 1
    return out


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor, _mma: bool = False, **epi) -> torch.Tensor:
    """K3: (M, K) int8 x (N, K) int8 -> (M, N), the weight operand transposed
    (K contiguous per output column).

    Epilogue keywords, one of: ``accumulators=True`` -> the int32 sums;
    ``fixed=(pre, m, sh)`` -> the probe's fixed-point requant to int8;
    else the serving epilogue (``ws``, ``b``, ``activation`` (default
    "linear"), and ``sx`` a 0-d input scale or a per-channel grid already
    folded into ``wq``, or ``sxg`` + ``splits`` for per-branch scales) ->
    fp32, or int8 at ``out_scale``.  Scales are tensors on the device.
    ``_mma`` (CUDA only) forces the ``mma.sync`` core, for A/B timing."""
    if xq.dim() != 2 or wq.dim() != 2 or xq.shape[1] != wq.shape[1]:
        raise ValueError(f"int8_gemm: (M, K) and (N, K) expected, got {tuple(xq.shape)} and "
                         f"{tuple(wq.shape)}")
    if xq.device.type == "cpu":
        return gemm_i8_ref(xq, wq, **epi)
    (m, k), n = xq.shape, wq.shape[0]
    return _igemm("int8_gemm", xq.view(m, 1, 1, k), wq.view(n, 1, 1, k), 1, 0, (m, n),
                  _mma=_mma, **epi)


def int8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int, pad: int, _mma: bool = False,
              **epi) -> torch.Tensor:
    """K4: NHWC int8 ``xq`` (N, H, W, C) conv (O, KH, KW, C) int8 ``wq``,
    zero padding ``pad`` on each side -> NHWC (N, Ho, Wo, O), with the
    epilogue of :func:`int8_gemm`."""
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[3] != wq.shape[3]:
        raise ValueError(f"int8_conv: (N, H, W, C) and (O, KH, KW, C) expected, got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if xq.device.type == "cpu":
        return int8_conv_ref(xq, wq, stride, pad, **epi)
    n, h, w, _ = xq.shape
    o, kh, kw, _ = wq.shape
    ho, wo = (h + 2 * pad - kh) // stride + 1, (w + 2 * pad - kw) // stride + 1
    if ho < 1 or wo < 1:
        raise ValueError(f"int8_conv: empty output for {tuple(xq.shape)} with a {kh}x{kw} "
                         f"kernel, stride {stride}, pad {pad}")
    return _igemm("int8_conv", xq, wq, stride, pad, (n, ho, wo, o), _mma=_mma, **epi)

"""The detection path's hand-written CUDA kernels, their plain versions, and
their build.

Two kernels, each the counterpart of a Pallas TPU kernel in
``pytorch_yolo_tpu/ops/pallas_kernels.py``:

* **K1** :func:`decode_score_head` (``csrc/decode_score.cu``): one head's
  raw map -> (N, R, 8) rows ``[x1, y1, x2, y2, obj, cls_score, cls_id, rank]``.
* **K2** :func:`nms_keep` (``csrc/nms_keep.cu``): batched greedy-NMS keep
  mask by parallel fixpoint.

Each has a plain torch version beside it (``*_ref``).  A wrapper takes the
plain version only when its input lies on the CPU; for a CUDA tensor it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, so a
run can show that the main path went through the kernels.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` (Hopper)
into ``csrc/_build/`` as one shared library with a plain C interface,
loaded with ``ctypes``; the build reruns when a source is newer than the
library, and a failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading

import torch

from ..config import ModelSpec, head_strides
from .decode import head_decode_args

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
SOURCES = tuple(os.path.join(CSRC, f) for f in ("decode_score.cu", "nms_keep.cu"))
BUILD_DIR = os.path.join(CSRC, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libyolo_kernels.so")
BUILD_LOG = os.path.join(BUILD_DIR, "build.log")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"decode_score": 0, "nms_keep": 0}

MAX_ANCHORS = 8    # csrc/decode_score.cu: kMaxAnchors
MAX_NMS_K = 1024   # one thread per candidate in one block
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
    return all(os.path.getmtime(s) <= built for s in SOURCES)


def build(force: bool = False) -> str:
    """Compile the kernel library if it is missing or stale; returns its path."""
    if not force and _is_fresh():
        return LIBRARY
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIBRARY}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc exited {proc.returncode}: {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, LIBRARY)
    with open(BUILD_LOG, "w", encoding="utf-8") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    return LIBRARY


def load_library() -> ctypes.CDLL:
    """ctypes handle to the kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            f, ll = ctypes.c_float, ctypes.c_longlong
            lib.yolo_decode_score.argtypes = [p, p, i, i, i, i, i, ctypes.POINTER(f), f, f, f,
                                              i, i, i, ll, i, i, p]
            lib.yolo_decode_score.restype = i
            lib.yolo_nms_keep.argtypes = [p, p, p, p, i, i, f, i, p]
            lib.yolo_nms_keep.restype = i
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
    """K1: (N, Gy, Gx, A*(5+C)) fp32 raw head -> (N, Gy*Gx*A, 8) fp32 rows.

    ``out``, when given, is an (N, R, 8) fp32 view whose rows are contiguous
    (a row range of a larger (N, D, 8) buffer); the rows are written there."""
    n, gy, gx, ch = raw.shape
    a, attrs = len(anchors), 5 + num_classes
    if ch != a * attrs:
        raise ValueError(f"head has {ch} channels, expected {a}*(5+{num_classes})")
    if cls_act not in _CLS_ACT or score_mode not in _SCORE_MODE:
        raise ValueError(f"unknown cls_act {cls_act!r} or score_mode {score_mode!r}")
    rows = gy * gx * a
    if out is None:
        out = torch.empty((n, rows, 8), dtype=torch.float32, device=raw.device)
    elif (tuple(out.shape) != (n, rows, 8) or out.dtype != torch.float32
          or out.stride(2) != 1 or out.stride(1) != 8):
        raise ValueError(f"out must be an ({n}, {rows}, 8) fp32 view with contiguous rows")
    if raw.device.type == "cpu":
        out.copy_(decode_score_head_ref(raw, anchors, stride, num_classes, score_mode,
                                        cls_act, scale_xy, new_coords))
        return out

    if raw.dtype != torch.float32:
        raise ValueError(f"decode_score: raw must be float32, got {raw.dtype}")
    if not 1 <= a <= MAX_ANCHORS:
        raise ValueError(f"decode_score: {a} anchors, the kernel takes 1..{MAX_ANCHORS}")
    if out.device != raw.device or out.data_ptr() % 16:
        raise ValueError("decode_score: out must be 16-byte aligned on the input's device")
    rows_per_block = 128 if 128 * attrs * 4 <= 48 * 1024 else 32
    if rows_per_block * attrs * 4 > _SMEM_LIMIT:
        raise ValueError(f"decode_score: {num_classes} classes exceed the shared-memory tile")
    device, stream = _cuda_args("decode_score", raw)
    anchors_wh = (ctypes.c_float * (2 * a))(*[float(v) for wh in anchors for v in wh])
    rc = load_library().yolo_decode_score(
        raw.data_ptr(), out.data_ptr(), n, gy, gx, a, num_classes, anchors_wh,
        float(stride), float(scale_xy), 0.5 * (float(scale_xy) - 1.0), int(new_coords),
        _CLS_ACT[cls_act], _SCORE_MODE[score_mode], out.stride(0), rows_per_block,
        device, stream)
    _raise_on(rc, "decode_score")
    LAUNCHES["decode_score"] += 1
    return out


def decode_score_all(heads: tuple[torch.Tensor, ...], spec: ModelSpec,
                     score_mode: str = "obj") -> torch.Tensor:
    """K1 over every head -> (N, D, 8), each head written into its row range."""
    strides = head_strides(spec)
    sizes = [h.shape[1] * h.shape[2] * len(s.anchors) for h, s in zip(heads, spec.yolo_layers)]
    out = torch.empty((heads[0].shape[0], sum(sizes), 8), dtype=torch.float32,
                      device=heads[0].device)
    r0 = 0
    for raw, head, stride, rows in zip(heads, spec.yolo_layers, strides, sizes):
        anchors, cls_act, sxy, nc = head_decode_args(head, stride)
        decode_score_head(raw, anchors, stride, head.classes, score_mode=score_mode,
                          cls_act=cls_act, scale_xy=sxy, new_coords=nc,
                          out=out[:, r0:r0 + rows])
        r0 += rows
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
    keep = torch.empty((n, k), dtype=torch.bool, device=boxes.device)
    rc = load_library().yolo_nms_keep(
        boxes.data_ptr(), valid.data_ptr(), None if cls_id is None else cls_id.data_ptr(),
        keep.data_ptr(), n, k, float(iou_thresh), device, stream)
    _raise_on(rc, "nms_keep")
    LAUNCHES["nms_keep"] += 1
    return keep

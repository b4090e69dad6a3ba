"""HTTP detection server with transparent micro-batching.

A copy of ``pytorch_yolo_tpu/serve.py`` on the port's ``Detector``:

* **Micro-batching**: concurrent requests are letterboxed on their own
  threads, queued, and coalesced by a single device thread into one
  ``detect_prepared`` call — up to ``batch_max`` images or
  ``batch_timeout_ms``, whichever first.  The card sees large batches even
  when clients send single images, and the prepared pipeline serves every
  client resolution.
* **Bounded pipeline keys**: batches are padded to the next power of two
  (<= batch_max), so at most log2(batch_max)+1 pipelines are ever built.
  On a mesh-bound detector the bucket is rounded up to a multiple of the
  mesh size (``bucket_floor``), and ``batch_max`` with it.
* **uint8 transfer** end-to-end: request bytes -> decoded uint8 -> rounded
  uint8 letterbox canvas -> device (/255 on the device).

Endpoints:
  POST /detect        image bytes (jpeg/png/...) -> JSON detections
  GET  /healthz       liveness + model summary
  GET  /stats         rolling latency/throughput (utils/profiling)

stdlib-only (http.server + threading) by design.  Images are decoded with
OpenCV where ``cv2`` is importable; a host without it still serves PNG,
decoded with the standard library alone (:func:`decode_png`: 8-bit gray,
RGB or RGBA, not interlaced).  :func:`encode_png` is the matching
standard-library writer the command line uses without OpenCV.
"""

from __future__ import annotations

import json
import logging
import struct
import threading
import time
import zlib
from dataclasses import dataclass, field

import numpy as np

from .ops.preprocess import letterbox_host
from .parallel.sharding import pad_to_multiple

# Reject request bodies above this size before reading them (a single huge
# Content-Length must not be able to exhaust server memory).
MAX_BODY_BYTES = 32 * 1024 * 1024


def decode_png(data: bytes) -> "np.ndarray | None":
    """PNG bytes -> (H, W, 3) uint8 BGR, as ``cv2.imdecode(...,
    IMREAD_COLOR)`` gives it, for 8-bit gray, RGB and RGBA images without
    interlacing (alpha dropped); None for anything else."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        return None
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if hdr is None:
        return None
    w, h, depth, color, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        return None
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error:
        return None
    stride = w * channels
    if raw.size != h * (stride + 1):
        return None
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 1:    # Sub: a running sum along the row, per channel
            line = np.cumsum(line.reshape(w, channels), axis=0).reshape(-1) & 0xFF
        elif kind == 2:  # Up
            line = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: pixel by pixel
            for x in range(0, stride, channels):
                a = line[x - channels:x] if x else np.zeros(channels, np.int32)
                b = prev[x:x + channels]
                if kind == 3:
                    pred = (a + b) // 2
                else:
                    c = prev[x - channels:x] if x else np.zeros(channels, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                line[x:x + channels] = (line[x:x + channels] + pred) & 0xFF
        elif kind != 0:
            return None
        out[y] = line
        prev = line
    img = out.reshape(h, w, channels)
    if channels == 1:
        return np.repeat(img, 3, axis=-1)
    return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) -> BGR


def encode_png(img_bgr: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 BGR image as PNG bytes: 8-bit RGB, every row
    filter 0, one zlib stream at level 1 (fast); :func:`decode_png` and
    OpenCV read it back exactly."""
    h, w, _ = img_bgr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img_bgr[..., ::-1]).reshape(h, w * 3)], 1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def decode_image(data: bytes) -> "np.ndarray | None":
    """Image bytes -> (H, W, 3) uint8 BGR: OpenCV where importable, else
    :func:`decode_png`.  None if the bytes do not decode."""
    try:
        import cv2
    except ImportError:
        return decode_png(data)
    return cv2.imdecode(np.frombuffer(data, dtype=np.uint8), cv2.IMREAD_COLOR)


def _pow2_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


def _mesh_bucket(n: int, cap: int, floor: int) -> int:
    """The batch a flush of ``n`` requests actually runs: the pow2 bucket
    rounded UP to a multiple of ``floor`` (batches must divide a
    mesh-bound detector's mesh), capped at ``cap`` (itself a floor
    multiple)."""
    return min(pad_to_multiple(_pow2_bucket(n, cap), floor), cap)


def bucket_ladder(cap: int, floor: int = 1) -> list[int]:
    """Every batch size the MicroBatcher can dispatch — the exact set the
    server warmup must precompile so no first request waits on a compile."""
    return sorted({_mesh_bucket(n, cap, floor) for n in range(1, cap + 1)})


@dataclass
class _Pending:
    lb: np.ndarray          # letterboxed canvas (uint8)
    geo: list[float]        # [scale, pad_x, pad_y, orig_w, orig_h]
    event: threading.Event = field(default_factory=threading.Event)
    result: "dict | None" = None
    error: "str | None" = None


class MicroBatcher:
    """Coalesces concurrent detection requests into device batches."""

    def __init__(self, detector, size: int, conf: float, iou: float,
                 max_det: int = 300, batch_max: int = 8,
                 batch_timeout_ms: float = 5.0):
        self.det = detector
        self.size = size
        self.conf = conf
        self.iou = iou
        self.max_det = max_det
        # prepared-pipeline batches must divide a mesh-bound detector's
        # mesh, so the bucket floor is the mesh size and batch_max rounds up
        # to it
        self.bucket_floor = detector.mesh.size
        rounded = pad_to_multiple(batch_max, self.bucket_floor)
        if rounded != batch_max:
            logging.getLogger("pytorch_yolo_tpu_torch.serve").info(
                "batch_max %d rounded up to %d (multiple of the %d-device "
                "mesh)", batch_max, rounded, self.bucket_floor)
        self.batch_max = rounded
        self.timeout_s = batch_timeout_ms / 1e3
        self._queue: list[_Pending] = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="pyt-torch-batcher")
        self._thread.start()

    def submit(self, img: np.ndarray) -> _Pending:
        lb, g = letterbox_host(img, self.size, method=self.det.interp, out_dtype="uint8")
        p = _Pending(lb=lb, geo=[g.scale, g.pad_x, g.pad_y, g.orig_w, g.orig_h])
        with self._lock:
            self._queue.append(p)
        self._wake.set()
        return p

    def close(self) -> None:
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=5)

    # -- device thread --------------------------------------------------
    def _run(self) -> None:
        while not self._stop:
            self._wake.wait()
            if self._stop:
                return
            # brief coalescing window: let concurrent requests pile up
            deadline = time.perf_counter() + self.timeout_s
            while time.perf_counter() < deadline:
                with self._lock:
                    if len(self._queue) >= self.batch_max:
                        break
                time.sleep(0.0005)
            with self._lock:
                batch, self._queue = (self._queue[: self.batch_max],
                                      self._queue[self.batch_max:])
                if not self._queue:
                    self._wake.clear()
            if not batch:
                continue
            try:
                self._flush(batch)
            except Exception as e:  # surface device errors to every waiter
                for p in batch:
                    p.error = f"{type(e).__name__}: {e}"
                    p.event.set()

    def _flush(self, batch: "list[_Pending]") -> None:
        n = len(batch)
        run_n = _mesh_bucket(n, self.batch_max, self.bucket_floor)
        x = np.stack([p.lb for p in batch])
        geos = np.asarray([p.geo for p in batch], dtype=np.float32)
        if run_n != n:  # pad to the bucket so executables stay bounded
            x = np.concatenate(
                [x, np.zeros((run_n - n,) + x.shape[1:], x.dtype)])
            geos = np.concatenate(
                [geos, np.tile([[1.0, 0, 0, 1, 1]], (run_n - n, 1)).astype(np.float32)])
        res = self.det.detect_prepared(x, geos, self.size, conf=self.conf,
                                       iou=self.iou, max_det=self.max_det)
        dets = self.det._trim(res, n)
        for p, d in zip(batch, dets):
            names = self.det.class_names
            p.result = {
                "boxes": d.boxes.tolist(),
                "obj": d.obj.tolist(),
                "cls_score": d.cls_score.tolist(),
                "cls_id": d.cls_id.tolist(),
                "names": [names[c] for c in d.cls_id],
            }
            p.event.set()


def make_server(detector, host: str = "127.0.0.1", port: int = 0,
                size: int = 416, conf: float = 0.5, iou: float = 0.4,
                max_det: int = 300, batch_max: int = 8,
                batch_timeout_ms: float = 5.0):
    """Build a ThreadingHTTPServer wired to a :class:`MicroBatcher`.

    Returns the server; call ``.serve_forever()`` (or run it in a thread —
    the tests do) and ``.batcher.close()`` + ``.shutdown()`` to stop."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from .utils.profiling import PipelineStats

    batcher = MicroBatcher(detector, size, conf, iou, max_det=max_det,
                           batch_max=batch_max,
                           batch_timeout_ms=batch_timeout_ms)
    stats = PipelineStats()
    stats.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # route through logging, not stderr spam
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok",
                                 "classes": len(detector.class_names),
                                 "size": size, "batch_max": batch_max})
            elif self.path == "/stats":
                self._json(200, {"throughput_per_s": round(stats.throughput(), 3),
                                 "items": stats.items})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/detect":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._json(400, {"error": "bad Content-Length"})
                return
            if length <= 0:
                self._json(400, {"error": "empty body: send image bytes"})
                return
            if length > MAX_BODY_BYTES:
                self._json(413, {"error": f"body {length} bytes exceeds cap "
                                          f"{MAX_BODY_BYTES}"})
                return
            raw = self.rfile.read(length)
            with stats.stage("decode"):
                img = decode_image(raw)
            if img is None:
                self._json(400, {"error": "could not decode image bytes"})
                return
            with stats.stage("detect"):
                p = batcher.submit(img)
                p.event.wait(timeout=60)
            if p.error is not None:
                self._json(500, {"error": p.error})
            elif p.result is None:
                self._json(504, {"error": "detection timed out"})
            else:
                stats.count()
                self._json(200, p.result)

    server = ThreadingHTTPServer((host, port), Handler)
    server.batcher = batcher
    server.stats = stats
    return server

"""Pipelined video/webcam detection loop.

A copy of ``pytorch_yolo_tpu/video.py`` on the port's ``Detector``:

  decoder thread ──bounded queue──▶ dispatch loop ──in-flight queue──▶ sink
       (cv2.VideoCapture)           (letterbox+detect,                (host trim)
                                     asynchronous launches,
                                     depth-2 double buffer)

CUDA launches are asynchronous: ``detector.raw_result`` returns device
tensors as soon as the work is queued, so keeping ``depth`` frames in
flight overlaps the host decode of frame t+1/t+2 with the device work of
frame t.  The sink's copy of result t to the host is the only blocking
point (the mechanism of ``Detector.detect_stream``).  Decoder errors skip
the frame and are counted, not fatal.  Needs OpenCV (``cv2``).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np

from .api import Detection, Detector
from .utils.profiling import PipelineStats

_SENTINEL = object()
log = logging.getLogger(__name__)


@dataclass
class FrameResult:
    index: int
    frame: np.ndarray  # original BGR frame
    detection: Detection


def _decoder_thread(cap, frame_q: queue.Queue, stop: threading.Event,
                    errors: list[int]) -> None:
    idx = 0
    while not stop.is_set():
        try:
            ok, frame = cap.read()
        except Exception:
            errors.append(idx)
            idx += 1
            continue
        if not ok:
            break
        frame_q.put((idx, frame))
        idx += 1
    frame_q.put(_SENTINEL)


def run_video(
    source: "str | int",
    detector: Detector,
    size: int = 416,
    conf: float = 0.5,
    iou: float = 0.4,
    max_det: int = 300,
    depth: int = 2,
    on_result: Callable[[FrameResult], None] | None = None,
    stats: PipelineStats | None = None,
    max_frames: int | None = None,
) -> Iterator[FrameResult]:
    """Generator of per-frame detections with pipelined decode/compute.

    ``depth`` device batches stay in flight; ``on_result`` (if given) is
    invoked for every frame in order — or consume the generator directly."""
    import cv2

    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise IOError(f"cannot open video source {source!r}")

    stats = stats or PipelineStats()
    stats.start()
    frame_q: queue.Queue = queue.Queue(maxsize=depth * 2 + 2)
    stop = threading.Event()
    decode_errors: list[int] = []
    t = threading.Thread(target=_decoder_thread, args=(cap, frame_q, stop, decode_errors),
                         daemon=True)
    t.start()

    inflight: queue.Queue = queue.Queue()
    produced = 0

    def dispatch_one() -> bool:
        """Pull one frame from the decoder and dispatch it to the device."""
        item = frame_q.get()
        if item is _SENTINEL:
            return False
        idx, frame = item
        with stats.stage("dispatch"):
            # mesh-bound: pad batch-1 to the mesh (trimmed on consume)
            res = detector.raw_result(detector._pad_to_mesh(frame[None]), size=size, conf=conf,
                                      iou=iou, max_det=max_det)
        inflight.put((idx, frame, res))
        return True

    try:
        draining = False
        for _ in range(depth):
            if not dispatch_one():
                draining = True
                break
        while not inflight.empty():
            idx, frame, res = inflight.get()
            if not draining and not dispatch_one():
                draining = True
            with stats.stage("collect"):
                detection = Detector._trim(res, 1)[0]
            stats.count()
            out = FrameResult(index=idx, frame=frame, detection=detection)
            if on_result is not None:
                on_result(out)
            yield out
            produced += 1
            if max_frames is not None and produced >= max_frames:
                break
    finally:
        stop.set()
        # Unblock the decoder (it may be waiting in frame_q.put), then join it
        # before cap.release(): concurrent read()/release() on a
        # cv2.VideoCapture is not thread-safe.
        deadline = 5.0
        t_end = time.monotonic() + deadline
        while t.is_alive() and time.monotonic() < t_end:
            try:
                while True:
                    frame_q.get_nowait()
            except queue.Empty:
                pass
            t.join(timeout=0.05)
        if t.is_alive():  # stuck inside cap.read(); releasing is the lesser evil
            log.warning("decoder thread did not exit within %.0fs; releasing capture", deadline)
        cap.release()

    if decode_errors:
        log.warning("skipped %d undecodable frames", len(decode_errors))

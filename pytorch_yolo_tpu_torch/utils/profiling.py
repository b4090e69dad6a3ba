"""Timing and throughput stats for the command line, the video loop and
the server, and the pipeline and stage profilers.

Counterpart of ``pytorch_yolo_tpu/utils/profiling.py``.  ``StageStats``,
``PipelineStats`` and :func:`stage_cut_points` are copies (host clocks;
the device work they bracket ends in a device-to-host copy, which
synchronizes).  :func:`profile_pipeline` and :func:`profile_stages` return
the original's rows, but where the JAX functions compile one truncated
program per cut and difference their times (XLA fuses across cuts), the
port runs the pipeline eagerly once an iteration and marks each cut as it
passes: a CUDA event on the card, the host clock on the CPU (where every
op has finished when it returns).  So each row's ``delta_ms`` is the time
between two marks and the deltas add up to the last ``cum_ms``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass
class StageStats:
    name: str
    samples_ms: list[float] = dataclasses.field(default_factory=list)

    def add(self, seconds: float) -> None:
        self.samples_ms.append(seconds * 1e3)

    def summary(self) -> dict[str, float]:
        if not self.samples_ms:
            return {"count": 0}
        a = np.asarray(self.samples_ms)
        return {
            "count": int(a.size),
            "mean_ms": float(a.mean()),
            "p50_ms": float(np.percentile(a, 50)),
            "p95_ms": float(np.percentile(a, 95)),
            "min_ms": float(a.min()),
            "max_ms": float(a.max()),
        }


class PipelineStats:
    """Per-stage latency percentiles + end-to-end throughput."""

    def __init__(self) -> None:
        self.stages: dict[str, StageStats] = {}
        self._t0: float | None = None
        self.items = 0

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        s = self.stages.setdefault(name, StageStats(name))
        t = time.perf_counter()
        try:
            yield
        finally:
            s.add(time.perf_counter() - t)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def count(self, n: int = 1) -> None:
        self.items += n

    def throughput(self) -> float:
        if self._t0 is None or self.items == 0:
            return 0.0
        dt = time.perf_counter() - self._t0
        return self.items / dt if dt > 0 else 0.0

    def report(self) -> str:
        lines = [f"items: {self.items}  throughput: {self.throughput():.2f}/s"]
        for name, s in self.stages.items():
            m = s.summary()
            if m.get("count"):
                lines.append(
                    f"  {name:<10} mean {m['mean_ms']:7.2f} ms  p50 {m['p50_ms']:7.2f}"
                    f"  p95 {m['p95_ms']:7.2f}  n={m['count']}"
                )
        return "\n".join(lines)


class _Clock:
    """Marks on one device's work: CUDA events on that device's current
    stream (whatever device is current), or the host clock on the CPU."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.cuda = device.type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def ms(self, start, end) -> float:
        """ms between two marks; call after :meth:`sync`."""
        return start.elapsed_time(end) if self.cuda else (end - start) * 1e3

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)


def _timed(clock: _Clock, run, iters: int) -> list[float]:
    """Mean ms from the start of a run to each mark ``run(marks)`` appends,
    over ``iters`` runs after one warm-up run."""
    run([])
    clock.sync()
    cum = 0.0
    for _ in range(iters):
        marks = [clock.mark()]
        run(marks)
        clock.sync()
        cum = cum + np.asarray([clock.ms(marks[0], m) for m in marks[1:]])
    return [float(v) for v in cum / iters]


def profile_pipeline(detector, size: "int | tuple[int, int]" = 416, batch: int = 8,
                     iters: int = 10, orig: tuple[int, int] = (480, 640),
                     conf: float = 0.6, iou: float = 0.45) -> list[dict]:
    """End-to-end pipeline cost split of the detector's pipeline: letterbox
    / forward / decode / NMS, on ``batch`` random uint8 ``orig`` frames
    already on the detector's device (the rows of the JAX function)."""
    from ..ops.kernels import decode_score_all
    from ..ops.nms import batched_nms_fused
    from ..ops.preprocess import letterbox_batch

    rng = np.random.default_rng(0)
    imgs = torch.from_numpy(rng.integers(0, 256, size=(batch,) + tuple(orig) + (3,),
                                         dtype=np.uint8)).to(detector.device)
    clock = _Clock(detector.device)
    names = ("letterbox", "+forward", "+decode", "+nms")

    def run(marks: list) -> None:
        x = letterbox_batch(imgs, size=size, bgr=True, method=detector.interp)
        marks.append(clock.mark())
        heads = detector.model(x, _native_heads=True)
        marks.append(clock.mark())
        rows = decode_score_all(heads, detector.spec, score_mode=detector.score_mode)
        marks.append(clock.mark())
        batched_nms_fused(rows, conf_thresh=conf, iou_thresh=iou, max_det=300)
        marks.append(clock.mark())

    out: list[dict] = []
    prev = 0.0
    for name, cum in zip(names, _timed(clock, run, iters)):
        out.append({"stage": name, "cum_ms": round(cum, 3), "delta_ms": round(cum - prev, 3),
                    "img_per_s": round(batch / (cum / 1e3), 1)})
        prev = cum
    return out


def stage_cut_points(spec) -> list[tuple[int, str]]:
    """(layer_index, label) after each spatial-resolution change + each head.

    These are the natural cost boundaries of a Darknet backbone: every
    stride-changing layer starts a new stage."""
    from ..config import (ConvSpec, MaxPoolSpec, RegionSpec, ReorgSpec,
                          UpsampleSpec, YoloSpec)

    cuts: list[tuple[int, str]] = []
    stride = 1
    for layer in spec.layers:
        changed = (isinstance(layer, (ConvSpec, MaxPoolSpec, ReorgSpec))
                   and layer.stride > 1) or isinstance(layer, UpsampleSpec)
        if changed and layer.index > 0:
            cuts.append((layer.index - 1, f"stride{stride} stage"))
        if isinstance(layer, (ConvSpec, MaxPoolSpec, ReorgSpec)):
            stride *= layer.stride
        elif isinstance(layer, UpsampleSpec):
            stride //= layer.stride
        if isinstance(layer, (YoloSpec, RegionSpec)):
            cuts.append((layer.index, f"head@{layer.index}"))
    if not cuts or cuts[-1][0] != len(spec.layers) - 1:
        cuts.append((len(spec.layers) - 1, "tail"))
    # dedupe while keeping order (a head can directly precede a downsample)
    seen: set[int] = set()
    return [(i, n) for i, n in cuts if not (i in seen or seen.add(i))]


def profile_stages(detector, size: "int | tuple[int, int]" = 416, batch: int = 8,
                   iters: int = 10, cuts: "list[tuple[int, str]] | None" = None,
                   ) -> list[dict]:
    """Per-stage forward cost of the detector's model on a random
    (batch, size, size, 3) input: the ``layer``, ``stage``, ``cum_ms`` and
    ``delta_ms`` rows of the JAX function, one row a cut the forward
    reaches (under the packed s2d stem layer 0 is not one)."""
    cuts = cuts or stage_cut_points(detector.spec)
    h, w = (size, size) if isinstance(size, int) else size
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.random((batch, h, w, 3)).astype(np.float32)).to(detector.device)
    model, clock = detector.model, _Clock(detector.device)
    at = dict(cuts)
    reached: list = []

    def run(marks: list) -> None:
        reached.clear()

        def hook(i, _):
            if i in at:
                reached.append(i)
                marks.append(clock.mark())

        model.layer_hook = hook
        try:
            model(x)
        finally:
            model.layer_hook = None

    cum = _timed(clock, run, iters)
    out: list[dict] = []
    prev = 0.0
    for i, c in zip(reached, cum):
        out.append({"layer": i, "stage": at[i], "cum_ms": round(c, 3),
                    "delta_ms": round(c - prev, 3)})
        prev = c
    return out

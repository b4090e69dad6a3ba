"""The device trace of a few steps: ``torch.profiler`` over a segment of the
window, read back from its Chrome trace.

The segment starts and ends with nothing in flight, so every device operation
in it belongs to its ``steps`` batches; its window runs from the first device
operation's start to the last one's end.  ``busy_s`` is the union of the
device operations' intervals in it, and the idle gaps are what is left, each
named by what the host was doing when it began (the benchmark's
``bench.dispatch`` / ``bench.wait`` span and the innermost host operation).
Kernels are grouped by ``GROUPS``, a frozen copy of the table of
``tools/profile_torch_step.py`` (kernel-name substring, first match wins),
with one line added: any K5 kernel the table does not name.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import NamedTuple

GROUPS = (("k6_tile_kernel<false", "K6 int8 input quantizer"),
          ("k6_tile_kernel<true", "K6 absmax"),
          ("quantize_kernel", "K6 int8 input quantizer"),
          ("absmax_kernel", "K6 absmax"),
          ("wgmma_kernel<false", "K3 int8 GEMM (wgmma)"),
          ("wgmma_kernel<true", "K4 int8 conv (wgmma)"),
          ("igemm_kernel<false", "K3 int8 GEMM (mma.sync)"),
          ("igemm_kernel<true", "K4 int8 conv (mma.sync)"),
          ("pk::packed_kernel", "K4 int8 conv (packed RGB stem)"),
          ("conv_bf16_kernel<0", "K5 bf16 conv (gather)"),
          ("conv_bf16_kernel<1", "K5 bf16 conv (TMA A)"),
          ("conv_bf16_kernel<2", "K5 bf16 conv (im2col A)"),
          ("conv_bf16_kernel<4", "K5 bf16 conv (im2col A, C = 32)"),
          ("conv_bf16_kernel<5", "K5 bf16 conv (16-channel boxes)"),
          ("conv_bf16_kernel<7", "K5 bf16 conv (im2col_pad A)"),
          ("conv_bf16_halo", "K5 bf16 conv (halo)"),
          ("conv_bf16_packed", "K5 bf16 conv (packed stem)"),
          ("conv_bf16_kernel<true", "K5 bf16 conv (gather)"),
          ("conv_bf16_kernel<false", "K5 bf16 conv (TMA A)"),
          ("conv_bf16", "K5 bf16 conv (other route)"),
          ("decode_score", "K1 decode+score"), ("nms_keep", "K2 NMS keep"),
          ("nms_build", "K2 NMS keep"), ("nms_scan", "K2 NMS keep"),
          ("conv", "bf16 convs (cuDNN, cuBLAS)"), ("fprop", "bf16 convs (cuDNN, cuBLAS)"),
          ("gemm", "bf16 convs (cuDNN, cuBLAS)"), ("xmma", "bf16 convs (cuDNN, cuBLAS)"),
          ("nvjet", "bf16 convs (cuDNN, cuBLAS)"), ("flip", "letterbox"),
          ("upsample_bilinear", "letterbox"),
          ("div", "divide"), ("round", "round"), ("clamp", "clamp"), ("leaky", "leaky"),
          ("copy", "copies and casts"), ("add", "adds (bias, shortcut)"),
          ("sort", "top-K sort"), ("reduce", "reductions"), ("upsample", "upsample"),
          ("max_pool", "maxpool (SPP, the ladder)"), ("cat", "concat"))

_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def group_of(name: str) -> str:
    low = name.lower()
    for key, group in GROUPS:
        if key.lower() in low:
            return group
    return "other"


class Trace(NamedTuple):
    steps: int
    window_s: float
    busy_s: float
    groups: dict          # group -> device seconds in the window
    ops: dict             # device operation name -> seconds
    gaps: list            # the 10 longest [(seconds, what the host was doing)]
    device_ops: int       # device operations in the window


def record(segment, steps: int) -> Trace:
    """Run ``segment()`` (``steps`` batches, nothing in flight before or
    after) under ``torch.profiler`` and summarize its device trace."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        segment()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, "r", encoding="utf-8") as f:
            events = json.load(f)["traceEvents"]
    return summarize(events, steps)


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: list, steps: int) -> Trace:
    """Chrome-trace events (``ts`` and ``dur`` in microseconds) -> Trace."""
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        if cat in _DEVICE:
            device.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"]))
        elif cat in _HOST:
            host.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]), ev["name"], cat))
    if not device:
        return Trace(steps, 0.0, 0.0, {}, {}, [], 0)
    start = min(d[0] for d in device)
    end = max(d[1] for d in device)
    groups: dict = collections.defaultdict(float)
    ops: dict = collections.defaultdict(float)
    for s, e, name in device:
        groups[group_of(name)] += (e - s) * 1e-6
        ops[name] += (e - s) * 1e-6
    busy = _union([(s, e) for s, e, _ in device])
    host.sort()
    starts = [h[0] for h in host]
    longest = sorted(((b - a, a) for (_, a), (b, _) in zip(busy, busy[1:])), reverse=True)
    gaps = [(us * 1e-6, _doing(host, starts, a)) for us, a in longest[:10]]
    return Trace(steps, (end - start) * 1e-6, sum(e - s for s, e in busy) * 1e-6,
                 dict(groups), dict(ops), gaps, len(device))


def _doing(host: list, starts: list, t: float) -> str:
    """The benchmark's span and the innermost host operation running at t."""
    span, inner, inner_len = "", "", None
    for s, e, name, cat in host[:bisect.bisect_right(starts, t)]:
        if e < t:
            continue
        if name.startswith("bench."):
            span = name
        elif inner_len is None or e - s < inner_len:
            inner, inner_len = name, e - s
    return " > ".join(p for p in (span, inner) if p) or "host outside every span"


def per_step_ms(trace: "Trace | None", match) -> "float | None":
    """Device ms a step of the groups ``match(group)`` accepts; None where
    there is no trace or it holds none of them."""
    if trace is None or not trace.steps:
        return None
    s = sum(v for g, v in trace.groups.items() if match(g))
    return s / trace.steps * 1e3 if s > 0 else None


def conv_group(g: str) -> bool:
    """The fp conv groups: K5's routes and any cuDNN / cuBLAS conv."""
    return g.startswith("K5 bf16 conv") or g == "bf16 convs (cuDNN, cuBLAS)"

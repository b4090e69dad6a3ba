"""One run of one cell: set-up, the measured window, the comparison that
decides ``correct``, and the metrics.

``run_cell`` is the whole run; ``run.py`` adds the command line, the look
for the card and the check that no JAX module was loaded.  The program is
``pytorch_yolo_tpu_torch``: the benchmark hands it the cfg text, the folded
fp32 weights (as numpy) and the uint8 frames on the device, and drives
``Detector.raw_result``.  Nothing else of it is read but its launch counters
and, through the profiler, its kernel names.
"""

from __future__ import annotations

import gc
import random
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import torch

from . import check, roofline, synth
from .reference import darknet as reference
from .cells import Cell, reader
from .loop import IN_FLIGHT, ClosedLoop
from .trace import Trace, group_of, record


CHECK_BATCHES_PER_POOL = 2  # window batches judged of each frame-pool entry


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


class Run(NamedTuple):
    """What a metric reader reads."""

    batch: int
    window: list          # loop.Done of the batches completed in the window
    t0: float             # the window's start and end, host clock
    t_end: float
    enqueue_s: list       # raw_result's host time of each window batch outside the trace
    setup_s: float
    peak_window_bytes: int
    trace: "Trace | None"
    work: list            # roofline.ConvWork of the model at the cell's batch
    precision: str
    card: str


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return out.stdout.strip() or out.stderr.strip()


def build_program(cell: Cell, params: dict, device: torch.device, serve: dict):
    """The Detector under test, from the cfg text and the folded weights."""
    from pytorch_yolo_tpu_torch import Detector, build_spec, parse_cfg_text

    kw = dict(serve)
    kw["dtype"] = getattr(torch, kw.get("dtype", "float32"))
    spec = build_spec(parse_cfg_text(cell.cfg_text))
    return Detector(spec, params, device=device, keep_fp32_params=False, **kw)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float, wrap_call: "Callable | None" = None,
             serve: "dict | None" = None) -> dict:
    """The run's result line as a dict; the numbers compared under
    ``checks``.  ``wrap_call`` wraps the timed call (the fault tests) and
    ``serve`` replaces the configuration's Detector arguments (the control)."""
    tr, cfg = cell.traffic, cell.config
    size, batch = int(cfg["size"]), int(tr["batch"])
    cuda = device.type == "cuda"
    parts = {"start and imports": time.perf_counter() - t_start}

    def part(name: str, t: float) -> float:
        now = time.perf_counter()
        parts[name] = now - t
        return now

    t = time.perf_counter()
    from pytorch_yolo_tpu_torch.ops import kernels

    if cuda:
        kernels.load_library()  # builds csrc/ into csrc/_build/ on a checkout's first run
    t = part("kernel library", t)
    frames = synth.pool_frames(tr, seed, device)
    calib = synth.calib_frames(tr, seed, device)
    t = part("frames", t)
    weights, flat_w, flat_b = synth.make_weights(cell.cfg_text, cfg["obj_bias"], seed, calib,
                                                 size)
    params = synth.host_params(weights, flat_w, flat_b)
    del calib
    t = part("weights", t)
    det = build_program(cell, params, device, serve if serve is not None else cfg["serve"])
    del params
    t = part("program", t)

    def call(x):
        return det.raw_result(x, size=size, conf=tr["conf"], iou=tr["iou"],
                              max_det=tr["max_det"])

    results: dict = {}
    window_open = [False]

    def keep(done, slot) -> None:
        if window_open[0]:
            results[done.index] = tuple(s.numpy().copy() for s in slot)

    loop = ClosedLoop(wrap_call(call) if wrap_call else call, frames, keep)
    for _ in range(int(tr["warmup_batches"])):
        loop.step()
    loop.drain()
    counters = (kernels.LAUNCHES, getattr(kernels, "CONV_BF16_LAUNCHES", {}))
    before = [dict(c) for c in counters]
    loop.step()
    loop.drain()
    launches, routes = ({k: v - b.get(k, 0) for k, v in c.items() if v != b.get(k, 0)}
                        for c, b in zip(counters, before))
    for _ in range(IN_FLIGHT):
        loop.step()
    t = part("warm-up", t)
    setup_s = t - t_start
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # the window
    t0 = loop.done[-1].done
    first = len(loop.done)
    window_open[0] = True
    profiled: set = set()
    tr_summary = None
    while True:
        d = loop.step()
        if d is None:
            continue
        if trace and tr_summary is None and d.done - t0 >= seconds / 2:
            loop.drain()
            mark = loop.next
            steps = int(tr["profile_steps"])

            def segment():
                for _ in range(steps):
                    loop.step()
                loop.drain()

            tr_summary = record(segment, steps)
            profiled = set(range(mark, loop.next))
        if loop.done[-1].done - t0 > seconds:
            break
    window_open[0] = False
    loop.drain()
    t_close = t0 + seconds
    window = [d for d in loop.done[first:] if d.done <= t_close]
    if not window:
        raise RuntimeError(f"no batch completed within the {seconds} s window")
    t_end = window[-1].done
    attempted = batch * (loop.next - loop.done[first].index)
    completed = batch * len(loop.done[first:])
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    memory_peak = max(setup_peak, window_peak)

    # the program's state goes before the reference runs
    del det, loop, call
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    numbers = judge(cell, seed, frames, weights, results, window, size)
    t_judge = time.perf_counter() - t_judge
    limits = cfg["limits"]
    correct = check.verdict(numbers, limits) and completed == attempted

    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    precision = cfg["precision"]
    run = Run(batch, window, t0, t_end,
              [d.enqueued - d.start for d in window if d.index not in profiled],
              setup_s, window_peak, tr_summary,
              roofline.conv_work(cell.cfg_text, size, batch, precision), precision, card)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    log(f"card: {card}, {torch.cuda.device_count() if cuda else 0} visible, "
        f"power limit: {power_limit() if cuda else 'cpu run'}")
    log("set-up seconds by part: " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    log(f"launches in one step: {launches}; K5's by route: {routes}")
    log(f"window: {len(window)} batches of {batch} in {t_end - t0:.3f} s; judged "
        f"{numbers['images']} images of {numbers['batches']} batches, "
        f"{numbers['candidates']} candidates, {numbers['kept']} kept, in {t_judge:.3f} s; "
        "not compared: "
        f"row_gap_mean {numbers['row_gap_mean']!r}, row_gap_max {numbers['row_gap_max']!r}")
    result = {"correct": bool(correct), "attempted": attempted, "failed": attempted - completed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu", "kind": card,
                         "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if trace and tr_summary is not None:
        unclaimed = tr_summary.groups.get("other", 0.0)
        total = sum(tr_summary.groups.values())
        log(f"trace: {tr_summary.steps} steps, {tr_summary.device_ops} device operations, "
            f"window {tr_summary.window_s:.6f} s, busy {tr_summary.busy_s:.6f} s; device time "
            "by group: " + ", ".join(f"{g} {s:.6f}" for g, s in
                                     sorted(tr_summary.groups.items(), key=lambda kv: -kv[1])))
        log(f"device time no group claims: {unclaimed:.6f} s of {total:.6f} "
            f"({100.0 * unclaimed / total if total else 0.0:.3f} %): "
            + ", ".join(f"{n[:80]} {s:.6f}" for n, s in sorted(
                ((n, s) for n, s in tr_summary.ops.items() if group_of(n) == "other"),
                key=lambda kv: -kv[1])[:5]))
        result["device"].update(busy_s=tr_summary.busy_s, window_s=tr_summary.window_s)
        result["breakdown"] = {
            "device_ops": [[n[:160], s] for n, s in
                           sorted(tr_summary.ops.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[what[:160], s] for s, what in tr_summary.gaps[:10]]}
    result["judged"] = {k: numbers[k] for k in ("batches", "images", "candidates", "kept",
                                                 "row_gap_mean", "row_gap_max")}
    result["checks"] = {n: {"value": numbers[n], "limit": limits[n]} for n in check.NAMES}
    return result


def judge(cell: Cell, seed: int, frames: torch.Tensor, weights: dict, results: dict,
          window: list, size: int) -> dict:
    """The numbers of :mod:`check` over a sample, drawn from the seed, of the
    window's batches: ``CHECK_BATCHES_PER_POOL`` batches of each pool entry,
    every image of each.  The reference runs once a distinct frame, in
    blocks of ``ref_block`` frames."""
    tr = cell.traffic
    rng = random.Random(seed)
    by_pool: dict = {}
    for d in window:
        by_pool.setdefault(d.pool, []).append(d)
    chosen = []
    for pool in sorted(by_pool):
        ds = by_pool[pool]
        chosen += rng.sample(ds, min(CHECK_BATCHES_PER_POOL, len(ds)))
    ref = reference.Darknet(cell.cfg_text, weights, size)
    n, h, w = frames.shape[1], frames.shape[2], frames.shape[3]
    block = int(tr["ref_block"])
    per_image = []
    with torch.no_grad():
        for pool in sorted({d.pool for d in chosen}):
            mine = [d for d in chosen if d.pool == pool]
            for lo in range(0, n, block):
                x, geo = reference.letterbox(frames[pool, lo:lo + block], size)
                rows = ref.rows(x, geo)
                del x
                for d in mine:
                    boxes, obj, score, cls, keep = (torch.from_numpy(a[lo:lo + block]).to(
                        frames.device) for a in results[d.index])
                    for j in range(boxes.shape[0]):
                        prog = {"boxes": boxes[j], "obj": obj[j], "score": score[j],
                                "cls": cls[j], "keep": keep[j]}
                        per_image.append(check.judge_image(
                            prog, type(rows)(*(f[j] for f in rows)), tr["conf"], tr["iou"],
                            float(w), float(h), geo.scale))
                del rows
    numbers = check.merge(per_image)
    numbers["batches"] = len(chosen)
    return numbers


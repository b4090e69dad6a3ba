"""Small cells for the CPU tests: a cell of BENCHMARK.json at a size the CPU
runs in seconds, the same code path as on the card."""

import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import cells, harness  # noqa: E402

torch.set_num_threads(4)


def small_cell(workload: str, size: int, frame_h: int, frame_w: int, batch: int = 2, **traffic):
    cell = cells.load(workload, ROOT)
    return cell._replace(
        config=dict(cell.config, size=size),
        traffic=dict(cell.traffic, batch=batch, frame_h=frame_h, frame_w=frame_w,
                     warmup_batches=1, ref_block=batch,
                     profile_steps=2, **traffic))


def run(cell, seed: int = 5, seconds: float = 1.5, wrap_call=None, serve=None) -> dict:
    return harness.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                            time.perf_counter(), wrap_call=wrap_call, serve=serve)

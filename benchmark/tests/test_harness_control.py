"""The control: the program's own int8 path (w8a8, dynamic scales), the
precision below the configuration's bf16, put in the program's place, must
come out not correct.  On the CPU at a size a test run holds; on the card at
each cell's own size (``-m cuda``, with ``--noconftest`` no JAX is needed)."""

import os
import sys

import pytest
import torch
from bench_cells import ROOT, run, small_cell

SEEDS = (21, 22, 23)


@pytest.fixture(scope="module")
def cpu_cell():
    return small_cell("yolov3-416.bf16-b128", 256, 240, 320)


@pytest.mark.parametrize("seed", SEEDS)
def test_control_is_not_correct_on_the_cpu(cpu_cell, seed):
    # the control's batch takes 1-5 s on a shared CPU: a window that always holds one
    res = run(cpu_cell, seed=seed, seconds=6.0, serve=cpu_cell.config["control"]["serve"])
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("seed", SEEDS[:1])
def test_program_is_correct_on_the_cpu(cpu_cell, seed):
    res = run(cpu_cell, seed=seed, seconds=2.0)
    assert res["correct"], res["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["yolov3-416.bf16-b128", "yolov4-608.bf16-b64"])
def test_control_is_not_correct_on_the_card(card, workload):
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    from benchmark.readings import readings

    out = readings(workload, [31, 32, 33], 3.0, True, card)
    assert not any(r["correct"] for r in out), out
    prog = readings(workload, [31], 3.0, False, card)
    assert prog[0]["correct"], prog

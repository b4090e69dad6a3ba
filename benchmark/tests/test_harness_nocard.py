"""Without a card a run fails and prints no result; so does a checkout that
holds only the benchmark (no program)."""

import os
import shutil
import subprocess
import sys

import torch
from bench_cells import ROOT


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "yolov3-416.bf16-b128", "--seed", "5", "--seconds", "1",
                           "--trace", "0"], cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=env)


def test_run_exits_nonzero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(ROOT, env)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert not torch.cuda.is_available() or "CUDA" in proc.stderr


def test_run_exits_nonzero_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(str(tmp_path))
    assert proc.returncode != 0
    assert "{" not in proc.stdout

#!/usr/bin/env python3
"""Copy the port into a scratch directory with K5's promotion interval changed.

    python3 tools/k5_variant.py _scratch/p2 --promote 2

Copies ``pytorch_yolo_tpu_torch/`` (without its build) and ``cfg/`` into
DIR and rewrites ``kPromote`` (P: the stages the tensor cores chain before
one promotion) in DIR's ``csrc/conv_bf16.cuh`` (the main kernel's; the
halo route chains 16 k16 steps, a constant of its own), so that
``tools/k5_accuracy.py --root DIR`` and ``tools/profile_torch_step.py
--kernels --root DIR`` measure that P beside this one in one call on the
card.  DIR must lie under ``_scratch/`` (listed in ``.gitignore``), which
is the only place this tool replaces.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRATCH = os.path.join(ROOT, "_scratch")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir", help="a directory under _scratch/")
    ap.add_argument("--promote", type=int, required=True, help="kPromote")
    args = ap.parse_args()
    dest = os.path.realpath(args.dir)
    if os.path.commonpath([dest, SCRATCH]) != SCRATCH or dest == SCRATCH:
        raise SystemExit(f"{args.dir}: not a directory under {SCRATCH}")
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(os.path.join(ROOT, "pytorch_yolo_tpu_torch"),
                    os.path.join(dest, "pytorch_yolo_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copytree(os.path.join(ROOT, "cfg"), os.path.join(dest, "cfg"))
    src = os.path.join(dest, "pytorch_yolo_tpu_torch", "csrc", "conv_bf16.cuh")
    with open(src, encoding="utf-8") as f:
        text = f.read()
    text, n = re.subn(r"constexpr int kPromote = \d+;", f"constexpr int kPromote = {args.promote};",
                      text)
    if n != 1:
        raise SystemExit(f"kPromote not found once in {src}")
    with open(src, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"{args.dir}: kPromote={args.promote}")


if __name__ == "__main__":
    main()

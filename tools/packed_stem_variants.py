#!/usr/bin/env python3
"""Where K4's packed route (the int8 RGB stem) spends its time, on one GPU.

    python3 tools/packed_stem_variants.py            # yolov2's and yolov2-tiny's stems

Copies ``pytorch_yolo_tpu_torch/csrc/`` into ``_scratch/packed_variants/``
once a variant, takes one part of the work out of each copy's
``int8_packed.cu`` (the consumers' epilogue; building the rows of A, each
then all zeros; the producer's copies of the input spans) or runs it one
block an SM instead of two, builds each copy's
``int8_packed.cu`` alone with nvcc into a library of its own, all at
once, and times each on the yolov2 (3 -> 32) and yolov2-tiny (3 -> 16)
stems at batch 128, 416², stride 1, int8 out, from CUDA graphs, the
unchanged kernel first and last (its output checked against the plain
version).  The variants compute wrong outputs on purpose; nothing else
runs them.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "_scratch", "packed_variants")
# variant -> (text of csrc/int8_packed.cu, its replacement)
VARIANTS = {
    "as it is": [],
    "without the epilogue": [(
        "      // Epilogue, one m64 block at a time through the staging rows.",
        "      continue;")],
    "without building A": [(
        "        build_row(p, tl, buf, i, w);",
        "        for (int e = 0; e < 8; ++e) w[e] = 0;")],
    "without the copies": [(
        "      wg::cp_async16_u32(slot + (uint32_t)(g - from), a.x + g,",
        "      if (g < 0) wg::cp_async16_u32(slot + (uint32_t)(g - from), a.x + g,")],
    "one block an SM": [
        ("__launch_bounds__(wg::kThreads, 2)", "__launch_bounds__(wg::kThreads, 1)"),
        ("const int grid = per_sm * sms < p.tiles ? per_sm * sms : p.tiles;",
         "const int grid = sms < p.tiles ? sms : p.tiles;")],
}


def build(kernels) -> dict:
    """One library a variant, built in parallel; returns name -> CDLL."""
    csrc = os.path.join(ROOT, "pytorch_yolo_tpu_torch", "csrc")
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = os.path.join(OUT, str(i))
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d, ignore=shutil.ignore_patterns("_build"))
        src = os.path.join(d, "int8_packed.cu")
        with open(src, encoding="utf-8") as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} not found once in int8_packed.cu")
            text = text.replace(old, new)
        with open(src, "w", encoding="utf-8") as f:
            f.write(text)
        procs[name] = (d, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", os.path.join(d, "lib.so"),
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{out[-3000:]}")
        regs = [line.strip() for line in out.splitlines() if "Used" in line]
        print(f"{name}: {regs[0] if regs else ''}", flush=True)
        lib = ctypes.CDLL(os.path.join(d, "lib.so"))
        lib.yolo_int8_conv_packed.argtypes = [ctypes.POINTER(kernels._IgemmArgs),
                                              ctypes.c_int, ctypes.c_void_p]
        lib.yolo_int8_conv_packed.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from pytorch_yolo_tpu_torch.ops import kernels

    full = kernels.load_library()  # K6 quantizes the inputs
    libs = build(kernels)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    mode = {"sx": "static", "act": "leaky", "out": "scalar"}
    for stem, o in (("yolov2", 32), ("yolov2-tiny", 16)):
        kernels._lib = full
        xq, wq, st, pad, kw = cs.int8_case(rng, 3, 1, (128, 416, 416, 3), o, mode, dev)
        ref = kernels.int8_conv_ref(xq, wq, st, pad, **kw)
        times: dict = {}
        try:
            for name in [*libs, "as it is"]:
                kernels._lib = libs[name]
                out = kernels.int8_conv(xq, wq, st, pad, **kw)
                torch.cuda.synchronize()
                if name == "as it is" and not torch.equal(out, ref):
                    sys.exit(f"{stem}: the unchanged kernel disagrees with its plain version")
                times.setdefault(name, []).append(
                    cs.graph_ms(lambda: kernels.int8_conv(xq, wq, st, pad, **kw)))
        finally:
            kernels._lib = full
        print(json.dumps({"stem": stem, "batch": 128, "out_channels": o,
                          "device_ms": {k: [round(v, 4) for v in vs] for k, vs in times.items()},
                          "card": torch.cuda.get_device_name(0)}), flush=True)
        del xq, ref
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

"""How far the port's self-calibrated "auto" int8 detector sits from the JAX
package's, beside how far JAX sits from itself when its activation scales
move inside the band its percentile bisection leaves (JAX lands up to
2^(20/2^16) ~= 1.000212 above the exact order statistic the port takes).

On the live-weight yolov3-tiny (synthetic="live"), calibrated on two frames
at 256 with a bare ``quant_calib`` (recipe "auto"), for each draw it prints
one JSON line: the relative L2 distance of the heads from JAX's on a fixed
input, the largest per-conv bias-delta difference relative to the conv's
largest delta, and post-NMS set agreement on two frames.  Rows: ``port``
(the port's own calibration), ``fp32`` and ``port_no_delta`` (what the
test's bounds must reject), and ``jax_moved`` for each draw (JAX's scales
divided by U(1, 1.000212), seeds 1..N).  These are the readings behind
``tests/test_torch_quant.py::test_auto_detector_matches_jax``.

    JAX_PLATFORMS=cpu python tools/auto_band_cpu.py --draws 6
"""

import argparse
import json
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import pytorch_yolo_tpu as pj  # noqa: E402
import pytorch_yolo_tpu_torch as pt  # noqa: E402
from pytorch_yolo_tpu.ops import quant as jq  # noqa: E402
from pytorch_yolo_tpu_torch.utils.drift import detection_drift  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")
FRAMES = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
CALIB = [np.random.default_rng(10 + i).integers(0, 256, (480, 640, 3), dtype=np.uint8)
         for i in range(2)]
AUTO = dict(quant="w8a8", quant_calib=CALIB, quant_calib_size=256, synthetic="live")
HEAD_X = np.random.default_rng(0).uniform(0, 1, (2, 256, 256, 3)).astype(np.float32)


def heads(det):
    if isinstance(det, pj.Detector):
        return [np.asarray(h) for h in det._forward(det.params, jnp.asarray(HEAD_X))]
    with torch.no_grad():
        return [h.numpy() for h in det.model(torch.from_numpy(HEAD_X))]


def rel_l2(hs, ref):
    return float(np.sqrt(sum(((h - r) ** 2).sum() for h, r in zip(hs, ref)))
                 / np.sqrt(sum((r ** 2).sum() for r in ref)))


def delta_spread(deltas, ref):
    if not deltas:
        return 1.0
    return max(float(np.abs(np.subtract(deltas[i], d)).max() / np.abs(d).max())
               for i, d in ref.items())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--draws", type=int, default=6)
    args = ap.parse_args()
    ref_det = pj.Detector.load(TINY, use_pallas=True, **AUTO)
    ref_heads, expected = heads(ref_det), ref_det.detect_batch(FRAMES, size=256)
    ref_deltas = {int(k): v for k, v in ref_det.quant_state()["bias_delta"].items()}

    def row(name, det):
        state = det.quant_state() if det.quant is not None else {}
        deltas = {int(k): v for k, v in (state.get("bias_delta") or {}).items()}
        print(json.dumps({
            "row": name, "heads_rel_l2": rel_l2(heads(det), ref_heads),
            "delta_spread": delta_spread(deltas, ref_deltas),
            "set_agreement": detection_drift(
                expected, det.detect_batch(FRAMES, size=256)).set_agreement}), flush=True)

    ours = pt.Detector.load(TINY, device="cpu", **AUTO)
    row("port", ours)
    row("fp32", pt.Detector.load(TINY, device="cpu", synthetic="live"))
    state = ours.quant_state()
    row("port_no_delta", pt.Detector.load(
        TINY, device="cpu", quant="w8a8", synthetic="live", quant_act_scales=state["scales"],
        quant_skip_layers=frozenset(state["skip"])))
    collect = jq.collect_act_scales
    for seed in range(1, args.draws + 1):
        rng = np.random.default_rng(seed)
        jq.collect_act_scales = lambda *a, **k: {
            i: (np.asarray(v, np.float32) / rng.uniform(1, 1.000212, np.shape(v))).astype(
                np.float32) for i, v in collect(*a, **k).items()}
        try:
            moved = pj.Detector.load(TINY, use_pallas=True, **AUTO)
        finally:
            jq.collect_act_scales = collect
        row(f"jax_moved_{seed}", moved)


if __name__ == "__main__":
    main()

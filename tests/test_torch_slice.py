"""The detection slice end to end: ``pytorch_yolo_tpu_torch.Detector`` against
``pytorch_yolo_tpu.Detector`` on the same cfg, the same synthetic seed and
the same uint8 480x640 frames, fp32 / ``precision="highest"``.

The JAX side runs its Pallas kernels in interpret mode (``use_pallas=True``),
i.e. the TPU kernels' semantics, the port its kernels' plain versions.
Agreement is ``detection_drift(ref, port).set_agreement == 1.0``; matched
boxes agree within 1e-2 px on yolov3-tiny.  Full yolov3 with He-init
weights saturates every objectness to 1.0 (the top-K is decided by tie
order alone) and its activations reach ~1e5, so its boxes get the
statistical bound of ``tests/test_model.py``: 99% within 1e-2 px, none
beyond 0.1 px.  ``DriftStats.degenerate`` is not asserted: it fires on a
bit-exact match by design.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import pytorch_yolo_tpu as pj
from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu import weights as jw
from pytorch_yolo_tpu.utils import drift as jdrift
import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch.utils import drift as tdrift
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)


@pytest.mark.parametrize("name,batch", [("yolov3-tiny", 2), ("yolov3", 1)])
def test_slice_matches_jax(name, batch):
    cfg = os.path.join(ROOT, "cfg", f"{name}.cfg")
    imgs = FRAMES[:batch]
    ref = pj.Detector.load(cfg, use_pallas=True).detect_batch(imgs, size=416, conf=0.5, iou=0.4)
    port = pt.Detector.load(cfg, device="cpu").detect_batch(imgs, size=416, conf=0.5, iou=0.4)
    stats = tdrift.detection_drift(ref, port)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    devs = []
    for a, b in zip(ref, port):
        assert len(a) == len(b)
        np.testing.assert_array_equal(b.cls_id, a.cls_id)
        np.testing.assert_allclose(b.obj, a.obj, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(b.cls_score, a.cls_score, rtol=1e-5, atol=1e-6)
        assert b.boxes.dtype == np.float32 and b.cls_id.dtype == np.int32
        devs.append(np.abs(b.boxes - a.boxes).max(-1))
    devs = np.concatenate(devs)
    if name == "yolov3":
        assert stats.ref_sat_frac == 1.0  # the all-ties regime this case exists for
        assert np.quantile(devs, 0.99) <= 1e-2 and devs.max() <= 0.1, devs.max()
    else:
        assert devs.max() <= 1e-2, devs.max()


def test_drift_copy_matches_jax():
    rng = np.random.default_rng(4)

    def dets(n):
        return [pt.Detection(boxes=rng.uniform(0, 400, (m, 4)).astype(np.float32),
                             obj=rng.uniform(0.5, 1, m).astype(np.float32),
                             cls_score=rng.uniform(0.5, 1, m).astype(np.float32),
                             cls_id=rng.integers(0, 80, m).astype(np.int32))
                for m in rng.integers(0, 30, n)]

    a = dets(6)
    b = [pt.Detection(d.boxes + rng.normal(0, 3, d.boxes.shape).astype(np.float32),
                      d.obj, d.cls_score, d.cls_id) for d in a]
    assert (dataclasses.asdict(tdrift.detection_drift(a, b))
            == dataclasses.asdict(jdrift.detection_drift(a, b)))


def test_detector_entry_points():
    det = pt.load("yolov3-tiny", device="cpu")
    batch = det.detect_batch(FRAMES, size=320, conf=0.5)
    one = det.detect(FRAMES[1], size=320, conf=0.5)
    np.testing.assert_array_equal(one.boxes, batch[1].boxes)
    boxes, scores, classes = pt.detect(det, FRAMES[0], conf=0.5, size=320)
    np.testing.assert_array_equal(boxes, batch[0].boxes)
    np.testing.assert_array_equal(scores, batch[0].obj)
    np.testing.assert_array_equal(classes, batch[0].cls_id)
    # a device tensor in, the same answer out; BGRA and grayscale inputs coerced
    np.testing.assert_array_equal(
        det.detect_batch(torch.from_numpy(FRAMES), size=320, conf=0.5)[0].boxes, batch[0].boxes)
    bgra = np.concatenate([FRAMES, np.zeros_like(FRAMES[..., :1])], -1)
    np.testing.assert_array_equal(det.detect_batch(bgra, size=320, conf=0.5)[0].boxes,
                                  batch[0].boxes)
    assert len(det.detect_batch(FRAMES[..., :1], size=320, conf=0.5)) == 2
    res = det.raw_result(FRAMES, size=320, conf=0.5)
    assert tuple(res.boxes.shape) == (2, 300, 4) and res.valid.dtype == torch.bool
    assert len(det._pipelines) == 2  # one pipeline per key: batches 1 and 2
    with pytest.raises(ValueError, match="multiple of 32"):
        det.detect_batch(FRAMES, size=300)
    with pytest.raises(ValueError):
        det.detect_batch(FRAMES[0])


def test_pipeline_cache_is_lru():
    det = pt.Detector.load("yolov3-tiny", device="cpu")
    det.max_cached_pipelines = 2
    for conf in (0.5, 0.6, 0.7):
        det.raw_result(FRAMES[:1], size=128, conf=conf)
    assert [k.conf for k in det._pipelines] == [0.6, 0.7]


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pt.Detector.load("yolov3-tiny", device="cuda")


def test_real_weights_file_matches_synthetic(tmp_path):
    """A .weights file written by the JAX package loads into the same model."""
    cfg = os.path.join(ROOT, "cfg", "yolov3-tiny.cfg")
    with open(cfg, encoding="utf-8") as f:
        spec = jcfg.build_spec(jcfg.parse_cfg_text(f.read()))
    path = str(tmp_path / "t.weights")
    jw.write_weights_file(spec, jw.random_raw_params(spec), path)
    a = pt.Detector.load(cfg, path, device="cpu").detect_batch(FRAMES, size=256)
    b = pt.Detector.load(cfg, device="cpu").detect_batch(FRAMES, size=256)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.boxes, y.boxes)

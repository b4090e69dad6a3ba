"""The port's CUDA kernels against their plain torch versions, on the card.

Every case here needs an NVIDIA GPU and skips where
``torch.cuda.is_available()`` is false.  The file imports neither jax nor
the JAX package, so it runs on a machine without them:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: ``tests/conftest.py`` imports jax).  The case tables are
shared with ``tests/test_torch_kernels.py``, which holds the same plain
versions against the JAX package's Pallas kernels on the CPU.

Tolerances: decode rows rtol = atol = 1e-5 (``expf`` and summation order),
with box columns relative to the row's largest corner (a corner is a
difference of two values up to ~1e4 px); ``cls_id`` and keep masks exact.
"""

import numpy as np
import pytest
import torch

import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.utils.drift import detection_drift

ANCHORS = ((81, 82), (135, 169), (344, 319))
ANCHORS4 = ((12, 16), (19, 36), (40, 28), (36, 75))
REGION = tuple((w * 32, h * 32) for w, h in ((0.57273, 0.677385), (1.87446, 2.06253),
                                              (3.33843, 5.47434), (7.88282, 3.52778),
                                              (9.77052, 9.16828)))


def assert_rows_close(ours, ref, rtol=1e-6, atol=1e-6):
    """(…, 8) decode rows: see the module docstring for the box-column bound."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    scale = np.abs(ref[..., :4]).max(-1, keepdims=True)  # the row's largest corner
    assert (np.abs(ours[..., :4] - ref[..., :4]) <= atol + rtol * scale).all()
    np.testing.assert_allclose(ours[..., 4:6], ref[..., 4:6], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(ours[..., 6], ref[..., 6])
    np.testing.assert_allclose(ours[..., 7], ref[..., 7], rtol=rtol, atol=atol)


# (shape, anchors, stride, classes, kwargs, logit scale, pre-activated inputs)
DECODE_CASES = {
    "grid13": ((2, 13, 13, 255), ANCHORS, 32, 80, {}, 1.0, False),
    "grid26": ((2, 26, 26, 255), ANCHORS, 16, 80, {}, 1.0, False),
    "grid52": ((2, 52, 52, 255), ANCHORS, 8, 80, {}, 1.0, False),
    "rectangular": ((1, 8, 13, 255), ANCHORS, 32, 80, {}, 1.0, False),
    "region_softmax": ((2, 13, 13, 425), REGION, 32, 80, {"cls_act": "softmax"}, 2.0, False),
    "region_linear": ((1, 13, 13, 425), REGION, 32, 80, {"cls_act": "linear"}, 2.0, False),
    "scale_xy_1.05": ((2, 13, 13, 255), ANCHORS, 32, 80, {"scale_xy": 1.05}, 2.0, False),
    "scale_xy_1.2": ((2, 13, 13, 255), ANCHORS, 32, 80, {"scale_xy": 1.2}, 2.0, False),
    "new_coords_4anchor": ((2, 8, 8, 4 * 85), ANCHORS4, 8, 80,
                           {"cls_act": "linear", "scale_xy": 2.0, "new_coords": True}, 1.0, True),
    "obj_times_cls": ((1, 13, 13, 255), ANCHORS, 32, 80, {"score_mode": "obj*cls"}, 1.0, False),
}


def decode_input(name):
    shape, _, _, _, _, scale, pre = DECODE_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if pre:  # new_coords heads see values a logistic conv already squashed
        return rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
    return rng.normal(0.0, scale, size=shape).astype(np.float32)


def crowded_boxes(seed, n, k):
    """(N, K, 4) corner boxes in overlapping clusters, some exact duplicates,
    (N, K) valid with ~15% invalid rows, (N, K) class ids in 0..3."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(40, 376, size=(n, max(k // 12, 1), 2))
    pick = rng.integers(0, centers.shape[1], size=(n, k))
    cxy = np.take_along_axis(centers, pick[..., None], axis=1) + rng.normal(0, 8, (n, k, 2))
    wh = rng.uniform(10, 90, size=(n, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)
    dup = rng.uniform(size=(n, k)) < 0.1
    boxes[:, 1:][dup[:, 1:]] = boxes[:, :-1][dup[:, 1:]]  # ties with the row above
    valid = rng.uniform(size=(n, k)) > 0.15
    cls = rng.integers(0, 4, size=(n, k)).astype(np.float32)
    return boxes, valid, cls


NMS_CASES = [(seed, k, cw) for seed, k in ((0, 37), (1, 96), (2, 300)) for cw in (False, True)]


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_cuda_decode_score_matches_plain(cuda, name):
    _, anchors, stride, classes, kw, _, _ = DECODE_CASES[name]
    raw = torch.from_numpy(decode_input(name)).to(cuda)
    before = tk.LAUNCHES["decode_score"]
    ours = tk.decode_score_head(raw, anchors, stride, classes, **kw)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["decode_score"] == before + 1
    assert_rows_close(ours.cpu().numpy(),
                      tk.decode_score_head_ref(raw, anchors, stride, classes, **kw).cpu().numpy(),
                      rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,k,class_wise", NMS_CASES)
def test_cuda_nms_keep_matches_plain(cuda, seed, k, class_wise):
    boxes, valid, cls = (torch.from_numpy(a).to(cuda) for a in crowded_boxes(seed, 8, k))
    c = cls if class_wise else None
    before = tk.LAUNCHES["nms_keep"]
    ours = tk.nms_keep(boxes, valid, 0.45, c)
    torch.cuda.synchronize()
    assert tk.LAUNCHES["nms_keep"] == before + 1
    np.testing.assert_array_equal(ours.cpu().numpy(),
                                  tk.nms_keep_ref(boxes, valid, 0.45, c).cpu().numpy())


@pytest.mark.cuda
def test_cuda_decode_score_all_writes_every_row(cuda):
    """K1 over the three yolov3@416 heads into one preallocated (N, D, 8)."""
    spec = pt.Detector.load("yolov3", device="cpu").spec
    rng = np.random.default_rng(11)
    heads = tuple(torch.from_numpy(rng.normal(0, 1, (2, g, g, 255)).astype(np.float32)).to(cuda)
                  for g in (13, 26, 52))
    ours = tk.decode_score_all(heads, spec)
    ref = tk.decode_score_all(tuple(h.cpu() for h in heads), spec)
    assert tuple(ours.shape) == (2, 10647, 8)
    assert_rows_close(ours.cpu().numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_detector_matches_cpu(cuda):
    """The slice on the card (fp32, no TF32) agrees with the port on the CPU
    and goes through both kernels."""
    frames = np.random.default_rng(0).integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
    ref = pt.Detector.load("yolov3-tiny", device="cpu").detect_batch(frames, size=416)
    before = dict(tk.LAUNCHES)
    ours = pt.Detector.load("yolov3-tiny", device=cuda).detect_batch(frames, size=416)
    assert tk.LAUNCHES["decode_score"] == before["decode_score"] + 2  # one per head
    assert tk.LAUNCHES["nms_keep"] == before["nms_keep"] + 1
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    assert stats.box_p99_px <= 1e-2, stats.row()
    for a, b in zip(ref, ours):  # near-equal ranks may trade places: compare as sets
        np.testing.assert_array_equal(np.sort(a.cls_id), np.sort(b.cls_id))

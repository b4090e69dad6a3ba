"""The port's host modules against their JAX originals on the same inputs:
COCO evaluation and datasets, asset discovery, palette and drawing, the
85-column ``batched_nms`` and leader election, and the profiler's cut
points and rows.

Tolerances: mAP, AP and AP75 within 1e-12 (the same numpy arithmetic);
``Sample`` fields, asset reports, palettes, drawn images, keep masks and
cut points equal.
"""

import json
import struct
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_yolo_tpu.assets as jassets
import pytorch_yolo_tpu.datasets as jdata
import pytorch_yolo_tpu.eval as jeval
import pytorch_yolo_tpu_torch as pt
import pytorch_yolo_tpu_torch.assets as tassets
import pytorch_yolo_tpu_torch.datasets as tdata
import pytorch_yolo_tpu_torch.eval as teval
from pytorch_yolo_tpu.models.zoo import model_spec as jax_model_spec
from pytorch_yolo_tpu.ops import nms as jnms
from pytorch_yolo_tpu.utils import draw as jdraw
from pytorch_yolo_tpu.utils import palette as jpalette
from pytorch_yolo_tpu.utils import profiling as jprof
from pytorch_yolo_tpu_torch.ops import nms as tnms
from pytorch_yolo_tpu_torch.utils import draw as tdraw
from pytorch_yolo_tpu_torch.utils import palette as tpalette
from pytorch_yolo_tpu_torch.utils import profiling as tprof
from tests.torch_threads import one_torch_thread  # noqa: F401


def random_evals(seed: int, n: int):
    """``n`` images of random detections and ground truths over 6 classes,
    a fifth of the ground truths crowds; some detections copy a ground
    truth with jitter so every threshold sees matches."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        g = int(rng.integers(0, 7))
        xy = rng.uniform(0, 300, (g, 2))
        gt = np.concatenate([xy, xy + rng.uniform(5, 120, (g, 2))], 1)
        gcls = rng.integers(0, 6, g)
        crowd = rng.random(g) < 0.2
        m = int(rng.integers(0, 9))
        dxy = rng.uniform(0, 300, (m, 2))
        det = np.concatenate([dxy, dxy + rng.uniform(5, 120, (m, 2))], 1)
        dcls = rng.integers(0, 6, m)
        if g:
            k = min(m, g)
            det[:k] = gt[:k] + rng.normal(0, 4, (k, 4))
            dcls[:k] = np.where(rng.random(k) < 0.8, gcls[:k], dcls[:k])
        scores = np.round(rng.random(m), 2)  # rounded: score ties happen
        out.append(dict(det_boxes=det.astype(np.float32), det_scores=scores.astype(np.float32),
                        det_classes=dcls, gt_boxes=gt, gt_classes=gcls,
                        gt_crowd=crowd if rng.random() < 0.8 else None))
    return out


@pytest.fixture(scope="module")
def evals():
    return random_evals(0, 200)


@pytest.mark.parametrize("method", ["continuous", "coco101"])
@pytest.mark.parametrize("iou", [0.5, 0.75])
def test_evaluate_matches_jax(evals, method, iou):
    ours = teval.evaluate([teval.ImageEval(**e) for e in evals], iou_thresh=iou, method=method)
    ref = jeval.evaluate([jeval.ImageEval(**e) for e in evals], iou_thresh=iou, method=method)
    assert abs(ours["mAP"] - ref["mAP"]) <= 1e-12 and 0.0 < ref["mAP"] < 1.0
    assert ours["per_class"].keys() == ref["per_class"].keys()
    for c, ap in ref["per_class"].items():
        assert abs(ours["per_class"][c] - ap) <= 1e-12


def test_evaluate_coco_matches_jax(evals):
    ours = teval.evaluate_coco([teval.ImageEval(**e) for e in evals])
    ref = jeval.evaluate_coco([jeval.ImageEval(**e) for e in evals])
    for key in ("AP", "AP50", "AP75"):
        assert abs(ours[key] - ref[key]) <= 1e-12, key
    assert ours["per_threshold"].keys() == ref["per_threshold"].keys()


@pytest.mark.parametrize("method", ["continuous", "coco101"])
def test_average_precision_matches_jax(method):
    rng = np.random.default_rng(1)
    for n in (0, 1, 17, 300):
        tp = (rng.random(n) < 0.6).astype(float)
        for n_gt in (0, max(1, int(tp.sum())), n + 5):
            ours = teval.average_precision(tp, 1.0 - tp, n_gt, method=method)
            ref = jeval.average_precision(tp, 1.0 - tp, n_gt, method=method)
            assert (np.isnan(ours) and np.isnan(ref)) or abs(ours - ref) <= 1e-12


@pytest.fixture(scope="module")
def coco_json(tmp_path_factory):
    """A COCO instances file: sparse category ids, crowds, an image with no
    annotations."""
    rng = np.random.default_rng(2)
    cats = [1, 3, 7, 18, 44, 90]
    coco = {"images": [], "annotations": [],
            "categories": [{"id": c, "name": f"c{c}"} for c in reversed(cats)]}
    for i in range(12):
        coco["images"].append({"id": 500 + i, "file_name": f"{i:04d}.jpg", "width": 640,
                               "height": 480})
        for _ in range(int(rng.integers(0, 5)) if i != 3 else 0):
            coco["annotations"].append({
                "id": len(coco["annotations"]), "image_id": 500 + i,
                "category_id": int(rng.choice(cats)),
                "bbox": [float(v) for v in rng.uniform(1, 200, 4)],
                "iscrowd": int(rng.random() < 0.25)})
    path = tmp_path_factory.mktemp("coco") / "instances_val2017.json"
    path.write_text(json.dumps(coco), encoding="utf-8")
    return str(path), coco


@pytest.mark.parametrize("max_images,skip_crowd", [(None, False), (5, False), (None, True)])
def test_load_coco_matches_jax(coco_json, max_images, skip_crowd):
    path, coco = coco_json
    ours = list(tdata.load_coco(path, "/imgs", max_images=max_images, skip_crowd=skip_crowd))
    ref = list(jdata.load_coco(path, "/imgs", max_images=max_images, skip_crowd=skip_crowd))
    assert len(ours) == len(ref) == (max_images or 12)
    for a, b in zip(ours, ref):
        assert (a.image_id, a.path, a.width, a.height) == (b.image_id, b.path, b.width, b.height)
        for field in ("gt_boxes", "gt_classes", "gt_crowd"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert tdata.category_id_map(coco["categories"]) == jdata.category_id_map(coco["categories"])


def _asset_tree(root):
    """Weights (a release size, an odd one, a bad header), annotations and
    an image dir beside them."""
    (root / "w").mkdir()
    good = root / "w" / "yolov3-tiny.weights"
    good.write_bytes(struct.pack("<3i", 0, 2, 0) + b"\0" * (35_434_956 - 12))
    (root / "w" / "mine.weights").write_bytes(struct.pack("<3i", 0, 2, 0) + b"\0" * 100)
    (root / "w" / "bad.weights").write_bytes(struct.pack("<3i", -4, 2, 0))
    (root / "coco" / "annotations").mkdir(parents=True)
    (root / "coco" / "annotations" / "instances_val2017.json").write_text("{}")
    (root / "coco" / "val2017").mkdir()
    for i in range(6):
        (root / "coco" / "val2017" / f"{i}.jpg").write_bytes(b"x")
    return str(root)


def test_scan_assets_matches_jax(tmp_path, monkeypatch):
    """The same report on one tree (the JAX scanner's fixed drop points
    outside the repository set aside), and the parity command names the
    port's module."""
    monkeypatch.setattr(jassets, "SEARCH_DIRS", tassets.SEARCH_DIRS)
    monkeypatch.delenv("PYTORCH_YOLO_ASSETS", raising=False)
    root = _asset_tree(tmp_path)
    ours, ref = tassets.scan_assets([root]), jassets.scan_assets([root])
    assert ours.weights == [tassets.FoundWeights(**vars(w)) for w in ref.weights]
    assert (ours.annotations, ours.image_dirs) == (ref.annotations, ref.image_dirs)
    assert ours.ready and ours.matched_eval_pair() == ref.matched_eval_pair()
    assert [w.header_ok for w in ours.weights] == [False, True, True]
    text = tassets.report_text(ours)
    assert "python -m pytorch_yolo_tpu_torch evaluate --model yolov3 " in text
    assert tassets.EXPECTED_WEIGHTS == jassets.EXPECTED_WEIGHTS
    empty = tassets.scan_assets([str(tmp_path / "nothing")])
    assert not empty.ready and "remains blocked" in tassets.report_text(empty)
    monkeypatch.setenv("PYTORCH_YOLO_ASSETS", root)
    assert tassets.scan_assets() == ours


def test_palette_matches_jax():
    for n in (1, 80, 91):
        assert tpalette.class_colors(n) == jpalette.class_colors(n)


def _draw_inputs():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    boxes = np.array([[10, 12, 70, 90], [-5, 40, 30, 130], [100, 5, 150, 60]], np.float32)
    return img, boxes, np.array([0, 17, 85]), np.array([0.91, 0.5, 0.333], np.float32)


def test_draw_with_cv2_matches_jax():
    pytest.importorskip("cv2")
    img, boxes, cls, scores = _draw_inputs()
    names = [f"class{i}" for i in range(80)]
    ours = tdraw.draw_detections(img.copy(), boxes, cls, scores, names)
    ref = jdraw.draw_detections(img.copy(), boxes, cls, scores, names)
    np.testing.assert_array_equal(ours, ref)


def test_draw_without_cv2_outlines_in_class_color(monkeypatch):
    """With the cv2 import blocked the boxes' edges carry their class color
    and the label bar is filled; the rest of the image is untouched."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    img, boxes, cls, scores = _draw_inputs()
    names = [f"class{i}" for i in range(80)]
    out = tdraw.draw_detections(img.copy(), boxes, cls, scores, names)
    colors = tpalette.class_colors(80)
    x1, y1, x2, y2 = boxes[0].astype(int)
    for y, x in ((y2, (x1 + x2) // 2), ((y1 + y2) // 2, x1), ((y1 + y2) // 2, x2)):
        assert tuple(out[y, x]) == colors[0]
    assert tuple(out[(y1 + y2) // 2, x1 + 8]) == tuple(img[(y1 + y2) // 2, x1 + 8])
    assert tuple(out[30, 100]) == colors[85 % 80]  # box 2's left edge
    ty = max(y1, 17)
    assert (out[ty - 16:ty, x1:x1 + 7 * len("class0 0.91")] == colors[0]).all()  # label bar
    assert tuple(out[110, 155]) == tuple(img[110, 155])


def nms_rows(seed: int, n: int = 3, d: int = 500, c: int = 6) -> np.ndarray:
    """(N, D, 5+C) decoded rows with ties in objectness and class scores,
    in crowded clusters so suppression chains form."""
    rng = np.random.default_rng(seed)
    det = np.zeros((n, d, 5 + c), np.float32)
    centers = rng.uniform(20, 300, (n, 12, 2))
    pick = rng.integers(0, 12, (n, d))
    det[..., 0:2] = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 6, (n, d, 2))
    det[..., 2:4] = rng.uniform(10, 70, (n, d, 2))
    det[..., 4] = rng.choice([0.3, 0.55, 0.7, 0.9, 1.0], (n, d))
    det[..., 5:] = rng.choice([0.1, 0.5, 0.9], (n, d, c))
    return det


@pytest.mark.parametrize("score_mode", ["obj", "obj*cls"])
@pytest.mark.parametrize("class_agnostic", [False, True])
@pytest.mark.parametrize("max_det", [50, 300, 600])
def test_batched_nms_matches_jax(score_mode, class_agnostic, max_det):
    """Every field equal to JAX's batched_nms (ties in rank and class
    broken as lax.top_k and argmax break them; max_det past D clamps)."""
    det = nms_rows(4)
    ref = jnms.batched_nms(jnp.asarray(det), 0.5, 0.45, max_det, score_mode, class_agnostic)
    ours = tnms.batched_nms(torch.from_numpy(det), 0.5, 0.45, max_det, score_mode,
                            class_agnostic)
    assert int(ours.valid.sum()) > 0
    for name, a, b in zip(ours._fields, ours, ref):
        assert a.dtype == torch.from_numpy(np.array(b)).dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_leader_election_matches_jax_and_greedy(seed):
    """Leader election, JAX's and the greedy oracle give one keep mask on
    score-sorted candidates with duplicates and chains."""
    det = nms_rows(seed, n=1, d=200)[0]
    cx, cy, w, h = (det[:, i] for i in range(4))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    boxes[5] = boxes[4]  # an exact duplicate
    iou = tnms.iou_matrix(torch.from_numpy(boxes))
    valid = torch.from_numpy(np.random.default_rng(seed).random(200) < 0.8)
    ours = tnms.leader_election_suppress(iou, valid, 0.45)
    ref = jnms.leader_election_suppress(jnp.asarray(iou.numpy()), jnp.asarray(valid.numpy()), 0.45)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert torch.equal(ours, tnms.greedy_suppress(iou, valid, 0.45)) and 0 < int(ours.sum()) < 200


@pytest.mark.parametrize("name", ["yolov3", "yolov3-tiny", "yolov4"])
def test_stage_cut_points_match_jax(name):
    assert tprof.stage_cut_points(pt.model_spec(name)) == jprof.stage_cut_points(
        jax_model_spec(name))


def test_profile_rows_have_the_original_keys():
    """profile_pipeline's stages and profile_stages' cut rows, with the JAX
    functions' keys; the deltas add up to the last cum_ms."""
    det = pt.Detector.load("yolov3-tiny", device="cpu")
    pipe = tprof.profile_pipeline(det, size=64, batch=1, iters=1, orig=(48, 64))
    assert [r["stage"] for r in pipe] == ["letterbox", "+forward", "+decode", "+nms"]
    assert all(set(r) == {"stage", "cum_ms", "delta_ms", "img_per_s"} for r in pipe)
    stages = tprof.profile_stages(det, size=64, batch=1, iters=1)
    cuts = jprof.stage_cut_points(jax_model_spec("yolov3-tiny"))
    assert [(r["layer"], r["stage"]) for r in stages] == cuts
    assert all(set(r) == {"layer", "stage", "cum_ms", "delta_ms"} for r in stages)
    for rows in (pipe, stages):
        assert abs(sum(r["delta_ms"] for r in rows) - rows[-1]["cum_ms"]) <= 1e-3 * len(rows)
        assert all(isinstance(r["cum_ms"], float) and r["cum_ms"] >= 0 for r in rows)
    assert det.model.layer_hook is None

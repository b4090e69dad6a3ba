"""The plain reference against the program's CPU path (fp32, no TF32) at a
small input size, for both configurations: the same head maps, the same
rows, and every number of the comparison at rounding level."""

import numpy as np
import pytest
import torch
from bench_cells import small_cell

from benchmark import check, harness, synth
from benchmark.reference import darknet as ref

CASES = [("yolov3-416.bf16-b128", 128, 120, 160), ("yolov4-608.bf16-b64", 128, 144, 256)]


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def pair(request):
    workload, size, h, w = request.param
    cell = small_cell(workload, size, h, w)
    dev = torch.device("cpu")
    frames = synth.pool_frames(cell.traffic, 9, dev)[0]
    calib = synth.make_frames(2, h, w, 9, dev, pool=1, stream=2)[0]
    weights, fw, fb = synth.make_weights(cell.cfg_text, cell.config["obj_bias"], 9, calib, size)
    det = harness.build_program(cell, synth.host_params(weights, fw, fb), dev,
                                {"dtype": "float32", "precision": "highest"})
    return cell, frames, weights, det


def test_heads_match_the_program_fp32(pair):
    cell, frames, weights, det = pair
    size = cell.config["size"]
    x, _ = ref.letterbox(frames, size)
    want = ref.Darknet(cell.cfg_text, weights, size).forward(x)
    got = det.model(x.permute(0, 2, 3, 1).contiguous())
    assert len(got) == len(want)
    for g, r in zip(got, want):
        g = g.permute(0, 3, 1, 2)
        assert g.shape == r.shape
        assert float((g - r).abs().max()) <= 1e-4 * max(1.0, float(r.abs().max()))


def test_letterbox_matches_the_program(pair):
    cell, frames, _, _ = pair
    from pytorch_yolo_tpu_torch.ops.preprocess import letterbox_batch

    size = cell.config["size"]
    x, _ = ref.letterbox(frames, size)
    np.testing.assert_allclose(letterbox_batch(frames, size).permute(0, 3, 1, 2).numpy(),
                               x.numpy(), rtol=0, atol=1e-6)


def test_judged_numbers_at_rounding_level(pair):
    cell, frames, weights, det = pair
    tr, size = cell.traffic, cell.config["size"]
    res = det.raw_result(frames, size=size, conf=tr["conf"], iou=tr["iou"], max_det=tr["max_det"])
    x, geo = ref.letterbox(frames, size)
    rows = ref.Darknet(cell.cfg_text, weights, size).rows(x, geo)
    for j in range(frames.shape[0]):
        prog = {"boxes": res.boxes[j], "obj": res.obj[j], "score": res.cls_score[j],
                "cls": res.cls_id[j], "keep": res.valid[j]}
        out = check.judge_image(prog, type(rows)(*(f[j] for f in rows)), tr["conf"], tr["iou"],
                                frames.shape[2], frames.shape[1], geo.scale)
        assert out["row_gap_max"] < 1e-4 and out["cover_gap"] < 1e-4 and out["keep_errors"] == 0


def test_the_same_seed_gives_the_same_inputs():
    cell = small_cell("yolov3-416.bf16-b128", 96, 120, 160)
    dev = torch.device("cpu")
    seed = 2 ** 31 + 5
    a, b = (synth.pool_frames(cell.traffic, seed, dev) for _ in range(2))
    assert torch.equal(a, b) and not torch.equal(a, synth.pool_frames(cell.traffic, 6, dev))
    wa, wb = (synth.make_weights(cell.cfg_text, cell.config["obj_bias"], seed, a[0], 96)[1]
              for _ in range(2))
    assert torch.equal(wa, wb)
    assert torch.equal(wa, wa.to(torch.bfloat16).to(torch.float32))  # served as bf16 exactly


def test_greedy_keep_matches_the_programs_nms():
    from pytorch_yolo_tpu_torch.ops.nms import batched_nms_fused

    g = torch.Generator().manual_seed(3)
    k = 64
    xy = torch.rand((1, k, 2), generator=g) * 100
    wh = torch.rand((1, k, 2), generator=g) * 40 + 5
    boxes = torch.cat([xy, xy + wh], dim=-1)
    obj = torch.rand((1, k), generator=g) * 0.5 + 0.5
    cls = torch.randint(0, 3, (1, k), generator=g).float()
    rows = torch.cat([boxes, obj[..., None], obj[..., None], cls[..., None], obj[..., None]], -1)
    res = batched_nms_fused(rows, conf_thresh=0.5, iou_thresh=0.45, max_det=k)
    keep = ref.greedy_keep(res.boxes[0], res.cls_id[0], 0.45)
    assert torch.equal(keep, res.valid[0])
    assert 0 < int(keep.sum()) < k

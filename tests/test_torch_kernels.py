"""The port's two kernels (K1 decode+score, K2 NMS keep) against the JAX
package's Pallas kernels.

On the CPU the port's wrappers run their plain torch versions and the JAX
kernels run in Pallas interpret mode; inputs are drawn with numpy from a
seed and handed to both.  The ``cuda`` cases compare each CUDA kernel with
its plain version on the card and skip where there is none.

Tolerances:
  * decode: rtol = atol = 1e-6 (the kernel test's own bound).  A box corner
    is ``bx -/+ bw/2``, a difference of two values up to ~1e4 px, so a
    one-ulp difference between XLA's and torch's ``exp`` shows up at the
    operands' scale; box columns are therefore held to 1e-6 relative to
    the row's largest corner magnitude.  ``cls_id`` is exact.
  * NMS keep masks: exact, on crowded boxes and on edge cases (a suppression
    chain, K = 1, 31, 32, 33, all rows invalid, identical boxes, NaN corners).
  * bf16 heads: rows equal to those of their fp32 widening, bit for bit.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from pytorch_yolo_tpu import config as jcfg
from pytorch_yolo_tpu.models.darknet import head_shapes
from pytorch_yolo_tpu.ops import nms as jnms
from pytorch_yolo_tpu.ops import pallas_kernels as jpk
from pytorch_yolo_tpu.ops.decode import decode_all as j_decode_all
from pytorch_yolo_tpu.ops.decode import head_decode_args as j_head_decode_args
from pytorch_yolo_tpu_torch import config as tcfg
from pytorch_yolo_tpu_torch.ops import kernels as tk
from pytorch_yolo_tpu_torch.ops import nms as tnms
from pytorch_yolo_tpu_torch.ops.decode import decode_all, decode_head, head_decode_args
from tests.test_torch_cuda import (ANCHORS, DECODE_CASES, NMS_CASES, assert_rows_close,
                                   crowded_boxes, decode_input, nms_input)
from tests.torch_threads import one_torch_thread  # noqa: F401

CFG_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "cfg")


def specs(name):
    """(JAX spec, port spec) parsed from ``cfg/<name>.cfg``."""
    with open(os.path.join(CFG_DIR, f"{name}.cfg"), encoding="utf-8") as f:
        text = f.read()
    return (jcfg.build_spec(jcfg.parse_cfg_text(text)),
            tcfg.build_spec(tcfg.parse_cfg_text(text)))


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decode_score_matches_pallas(name):
    shape, anchors, stride, classes, kw, _, _ = DECODE_CASES[name]
    raw = decode_input(name)
    ref = jpk.decode_score_head(jnp.asarray(raw), anchors, stride, classes, interpret=True, **kw)
    ours = tk.decode_score_head(torch.from_numpy(raw), anchors, stride, classes, **kw)
    assert tuple(ours.shape) == (shape[0], shape[1] * shape[2] * len(anchors), 8)
    assert_rows_close(ours.numpy(), ref)


def test_decode_score_class_tie_breaks_to_first():
    """Equal class logits: the lowest class index wins, as in the Pallas kernel."""
    g, classes = 4, 6
    raw = np.zeros((1, g, g, 3 * (5 + classes)), dtype=np.float32)
    for expect in (0, 2):
        ours = tk.decode_score_head(torch.from_numpy(raw), ANCHORS, 32, classes).numpy()
        ref = np.asarray(jpk.decode_score_head(jnp.asarray(raw), ANCHORS, 32, classes,
                                               interpret=True))
        assert (ours[..., 6] == expect).all()
        np.testing.assert_array_equal(ours[..., 6], ref[..., 6])
        for a in range(3):  # two-way tie at columns 2 and 4 for the next pass
            raw[..., a * (5 + classes) + 5 + 2] = 3.0
            raw[..., a * (5 + classes) + 5 + 4] = 3.0


def test_decode_score_all_matches_pallas():
    spec, tspec = specs("yolov3-tiny")
    rng = np.random.default_rng(0)
    heads = [rng.normal(0, 1, size=s).astype(np.float32) for s in head_shapes(spec, 416, 2)]
    ref = jpk.decode_score_all(tuple(map(jnp.asarray, heads)), spec, 416, use_pallas=True)
    ours = tk.decode_score_all(tuple(map(torch.from_numpy, heads)), tspec)
    assert tuple(ours.shape) == (2, 2535, 8)
    assert_rows_close(ours.numpy(), ref)
    # the full (N, D, 5+C) decode, the plain versions' oracle, against JAX's
    full = decode_all(tuple(map(torch.from_numpy, heads)), tspec).numpy()
    np.testing.assert_allclose(full, np.asarray(j_decode_all(tuple(map(jnp.asarray, heads)),
                                                             spec, 416)), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name,size", [("yolov3", 128), ("yolov3-tiny", 416)])
def test_decode_score_all_bf16_heads_match_pallas(name, size):
    """bf16 heads (the serving pipeline hands K1 the head convs' bf16
    output) give the rows of their fp32 widening bit for bit, and both match
    the Pallas kernel on the widened values."""
    spec, tspec = specs(name)
    rng = np.random.default_rng(4)
    heads = [torch.from_numpy(rng.normal(0, 2, size=s).astype(np.float32)).to(torch.bfloat16)
             for s in head_shapes(spec, size, 2)]
    wide = [h.to(torch.float32) for h in heads]
    ours = tk.decode_score_all(tuple(heads), tspec)
    np.testing.assert_array_equal(ours.numpy(), tk.decode_score_all(tuple(wide), tspec).numpy())
    ref = jpk.decode_score_all(tuple(jnp.asarray(h.numpy()) for h in wide), spec, size,
                               use_pallas=True)
    assert_rows_close(ours.numpy(), ref)


@pytest.mark.parametrize("name,size,batch", [("yolov3", 416, 3), ("yolov3-tiny", 416, 2),
                                             ("yolov4-p6", 128, 3)])
def test_decode_plan_covers_every_row_once(name, size, batch):
    """K1's launch table, walked as the kernel walks it (tile -> head by
    first_tile, DECODE_TILE_ROWS rows a tile, row n*R + r -> output row
    out_row0 + r of image n), writes each output row exactly once."""
    spec, tspec = specs(name)
    shapes = head_shapes(spec, size, batch)
    plans = tk.decode_plan(shapes, tspec)
    assert len(plans) == len(tspec.yolo_layers)
    d = plans[-1].out_row0 + plans[-1].rows
    assert d == sum(s[1] * s[2] * len(h.anchors) for s, h in zip(shapes, tspec.yolo_layers))
    firsts = [p.first_tile for p in plans]
    total = plans[-1].first_tile + plans[-1].tiles
    hits = np.zeros(batch * d, np.int64)
    t = tk.DECODE_TILE_ROWS
    for tile in range(total):
        p = plans[int(np.searchsorted(firsts, tile, side="right")) - 1]
        rows = np.arange((tile - p.first_tile) * t, min((tile - p.first_tile + 1) * t,
                                                        p.batch * p.rows))
        assert rows.size > 0
        np.add.at(hits, rows // p.rows * d + p.out_row0 + rows % p.rows, 1)
    np.testing.assert_array_equal(hits, 1)
    for p, s, head, stride in zip(plans, shapes, tspec.yolo_layers, tcfg.head_strides(tspec)):
        assert (p.batch, p.gy, p.gx, p.rows) == (batch, s[1], s[2], s[1] * s[2] * len(head.anchors))
        assert (p.anchors, p.cls_act, p.scale_xy, p.new_coords) == head_decode_args(head, stride)
        assert p.tiles == -(-batch * p.rows // t)
    with pytest.raises(ValueError):
        tk.decode_plan([(batch, 4, 4, 254)] + list(shapes[1:]), tspec)


def test_head_decode_args_match():
    for name in ("yolov3", "yolov2-tiny", "yolov4-csp", "yolov4", "yolov4-tiny", "yolov2",
                 "yolov3-spp"):
        spec, tspec = specs(name)
        assert tcfg.head_strides(tspec) == jcfg.head_strides(spec)
        for h, th, s in zip(spec.yolo_layers, tspec.yolo_layers, jcfg.head_strides(spec)):
            assert head_decode_args(th, s) == j_head_decode_args(h, s)


@pytest.mark.parametrize("name", ["grid13", "region_softmax", "new_coords_4anchor"])
def test_decode_score_ref_matches_full_decode(name):
    """The plain K1 equals the full (D, 5+C) decode reduced to 8 columns."""
    _, anchors, stride, classes, kw, _, _ = DECODE_CASES[name]
    raw = torch.from_numpy(decode_input(name))
    rows = tk.decode_score_head_ref(raw, anchors, stride, classes, **kw)
    kw = {k: v for k, v in kw.items() if k != "score_mode"}
    dec = decode_head(raw, anchors, stride, classes, **kw)
    corners = torch.stack([dec[..., 0] - dec[..., 2] / 2, dec[..., 1] - dec[..., 3] / 2,
                           dec[..., 0] + dec[..., 2] / 2, dec[..., 1] + dec[..., 3] / 2], -1)
    np.testing.assert_allclose(rows[..., :4].numpy(), corners.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rows[..., 4].numpy(), dec[..., 4].numpy())
    np.testing.assert_allclose(rows[..., 5].numpy(), dec[..., 5:].amax(-1).numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(rows[..., 6].numpy(), dec[..., 5:].argmax(-1).float().numpy())


def test_decode_score_out_view_and_checks():
    raw = torch.from_numpy(decode_input("grid13"))
    buf = torch.full((2, 600, 8), -7.0)
    tk.decode_score_head(raw, ANCHORS, 32, 80, out=buf[:, 50:557])
    np.testing.assert_array_equal(buf[:, 50:557].numpy(),
                                  tk.decode_score_head_ref(raw, ANCHORS, 32, 80).numpy())
    assert (buf[:, :50] == -7).all() and (buf[:, 557:] == -7).all()
    with pytest.raises(ValueError):
        tk.decode_score_head(raw, ANCHORS[:2], 32, 80)
    with pytest.raises(ValueError):
        tk.decode_score_head(raw, ANCHORS, 32, 80, out=torch.empty(2, 507, 8)[:, :, :4])


# ---------------------------------------------------------------------------
# K2: NMS keep mask
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,k,class_wise", NMS_CASES)
def test_nms_keep_matches_pallas_and_greedy(seed, k, class_wise):
    boxes, valid, cls = nms_input(seed, 3, k)
    c = cls if class_wise else None
    ref = np.asarray(jpk.nms_keep_pallas(jnp.asarray(boxes), jnp.asarray(valid), 0.45,
                                         cls_id=None if c is None else jnp.asarray(c),
                                         interpret=True))
    ours = tk.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45,
                       None if c is None else torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(ours, ref)
    for i in range(3):
        iou = tnms.iou_matrix(torch.from_numpy(boxes[i]))
        jiou = jnms.iou_matrix(jnp.asarray(boxes[i]))
        if class_wise:
            same = torch.from_numpy(np.abs(cls[i][:, None] - cls[i][None, :]) < 0.5)
            iou, jiou = iou * same, jiou * jnp.asarray(same.numpy())
        v = torch.from_numpy(valid[i])
        greedy = tnms.greedy_suppress(iou, v, 0.45).numpy()
        np.testing.assert_array_equal(greedy, np.asarray(
            jnms.greedy_suppress(jiou, jnp.asarray(valid[i]), 0.45)))
        np.testing.assert_array_equal(tnms.fixpoint_suppress(iou, v, 0.45).numpy(), greedy)
        np.testing.assert_array_equal(ours[i], greedy)
    if not isinstance(seed, str):
        assert 0 < ours.sum() < valid.sum()  # something kept, something suppressed


def test_nms_edge_cases_are_what_they_claim():
    """The named NMS cases: the chain keeps every other box and takes the
    fixpoint K rounds; identical boxes keep the first; all-invalid keeps
    nothing; NaN corners suppress nothing and are suppressed by nothing."""
    boxes, valid, _ = (torch.from_numpy(a) for a in nms_input("chain", 2, 300))
    over = tnms.iou_matrix(boxes) > 0.45
    assert tnms.fixpoint_rounds(over, valid) == 300
    keep = tk.nms_keep(boxes, valid, 0.45)
    assert keep[:, ::2].all() and not keep[:, 1::2].any()
    boxes, valid, _ = (torch.from_numpy(a) for a in nms_input("identical", 2, 40))
    np.testing.assert_array_equal(tk.nms_keep(boxes, valid, 0.45).numpy(),
                                  np.arange(40)[None].repeat(2, 0) == 0)
    boxes, valid, _ = (torch.from_numpy(a) for a in nms_input("all_invalid", 2, 64))
    assert not tk.nms_keep(boxes, valid, 0.45).any()
    boxes, valid, _ = (torch.from_numpy(a) for a in nms_input("nan_corners", 2, 96))
    nan = torch.isnan(boxes).any(-1)
    assert nan.any() and not (tnms.iou_matrix(boxes)[nan[:, :, None] | nan[:, None, :]]
                              > 0.45).any()
    assert torch.equal(tk.nms_keep(boxes, valid, 0.45)[nan], valid[nan])


def test_iou_matrix_matches_jax():
    boxes, _, _ = crowded_boxes(5, 1, 64)
    boxes[0, :3] = [[10, 10, 10, 30], [5, 5, 1, 1], [0, 0, 20, 20]]  # empty and inverted
    np.testing.assert_array_equal(tnms.iou_matrix(torch.from_numpy(boxes[0])).numpy(),
                                  np.asarray(jnms.iou_matrix(jnp.asarray(boxes[0]))))


def test_nms_keep_checks_inputs():
    boxes, valid, _ = crowded_boxes(0, 2, 8)
    b, v = torch.from_numpy(boxes), torch.from_numpy(valid)
    with pytest.raises(ValueError):
        tk.nms_keep(b[..., :3], v, 0.5)
    with pytest.raises(ValueError):
        tk.nms_keep(b, v.float(), 0.5)
    with pytest.raises(ValueError):
        tk.nms_keep(b, v, 0.5, cls_id=torch.zeros(2, 7))


def _fused_rows(seed, d, ties):
    rng = np.random.default_rng(seed)
    boxes, _, cls = crowded_boxes(seed, 2, d)
    obj = rng.uniform(0.3, 1.0, size=(2, d)).astype(np.float32)
    if ties:  # saturated objectness: every rank is exactly 1.0
        obj[:] = 1.0
    score = rng.uniform(0.2, 1.0, size=(2, d)).astype(np.float32)
    return np.concatenate([boxes, obj[..., None], score[..., None], cls[..., None],
                           obj[..., None]], -1)


@pytest.mark.parametrize("seed,d,max_det,ties", [(0, 500, 300, False), (1, 700, 300, True),
                                                  (2, 120, 300, False)])
def test_batched_nms_fused_matches_jax(seed, d, max_det, ties):
    """Top-K selection (stable, ties lowest index first), gather and keep
    mask against the JAX path with the Pallas kernel in interpret mode."""
    rows = _fused_rows(seed, d, ties)
    ref = jnms.batched_nms_fused(jnp.asarray(rows), conf_thresh=0.6, iou_thresh=0.45,
                                 max_det=max_det, use_pallas=True)
    ours = tnms.batched_nms_fused(torch.from_numpy(rows), conf_thresh=0.6, iou_thresh=0.45,
                                  max_det=max_det)
    for field in ("boxes", "obj", "cls_score", "cls_id", "valid"):
        np.testing.assert_array_equal(getattr(ours, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)


def test_topk_tie_order_matches_lax():
    """The selection sorts ties lowest index first, as lax.top_k does;
    torch.topk gives no such order."""
    x = np.array([1, .5, 1, 1, -1, 1.], np.float32)
    _, jidx = lax.top_k(jnp.asarray(x), 4)
    _, idx = torch.sort(torch.from_numpy(x), descending=True, stable=True)
    np.testing.assert_array_equal(idx[:4].numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx[:4].numpy(), [0, 2, 3, 5])
    rng = np.random.default_rng(3)
    y = rng.choice(np.array([1.0, 0.75, -1.0], np.float32), size=(4, 2000))
    _, jidx = jax.vmap(lambda r: lax.top_k(r, 300))(jnp.asarray(y))
    _, idx = torch.sort(torch.from_numpy(y), dim=1, descending=True, stable=True)
    np.testing.assert_array_equal(idx[:, :300].numpy(), np.asarray(jidx))


# ---------------------------------------------------------------------------
# Dispatch: the plain versions serve CPU tensors only
# ---------------------------------------------------------------------------


def test_cpu_path_launches_nothing():
    before = dict(tk.LAUNCHES)
    boxes, valid, cls = crowded_boxes(1, 2, 40)
    tk.nms_keep(torch.from_numpy(boxes), torch.from_numpy(valid), 0.5, torch.from_numpy(cls))
    tk.decode_score_head(torch.from_numpy(decode_input("grid13")), ANCHORS, 32, 80)
    assert tk.LAUNCHES == before


def test_other_devices_raise_instead_of_falling_back():
    raw = torch.empty((1, 13, 13, 255), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.decode_score_head(raw, ANCHORS, 32, 80)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.nms_keep(torch.empty((1, 8, 4), device="meta"),
                    torch.empty((1, 8), dtype=torch.bool, device="meta"), 0.5)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(tk, "_nvcc", lambda: "false")  # a compiler that always fails
    monkeypatch.setattr(tk, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(tk, "LIBRARY", str(tmp_path / "lib.so"))
    with pytest.raises(tk.KernelBuildError, match="exited 1"):
        tk.build()

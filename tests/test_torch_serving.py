"""The port's serving surface against the JAX package's: the prepared
pipeline (``detect_prepared``, ``detect_many``, ``detect_stream``,
``warmup``), cubic letterboxing, checkpoints both ways, the zoo, the
server (``bucket_ladder``, ``MicroBatcher``, ``make_server``) and the
video loop.

Detectors are yolov3-tiny at fp32 / "highest" with He weights (seed 0),
the JAX one on its plain jnp path.  Detections agree at set agreement 1.0
(``utils.drift.detection_drift``); letterbox canvases within 1e-5 on
[0, 1] (the cubic weights are built with the same fp32 operations and
XLA's fused sample position; the sums run in another order).
"""

import json
import os
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pytorch_yolo_tpu as pj
from pytorch_yolo_tpu import serve as jserve
from pytorch_yolo_tpu.models import zoo as jzoo
from pytorch_yolo_tpu.ops import postprocess as jpost
from pytorch_yolo_tpu.ops import preprocess as jpre
import pytorch_yolo_tpu_torch as pt
from pytorch_yolo_tpu_torch import serve as tserve
from pytorch_yolo_tpu_torch import video as tvideo
from pytorch_yolo_tpu_torch.models import zoo as tzoo
from pytorch_yolo_tpu_torch.ops import postprocess as tpost
from pytorch_yolo_tpu_torch.ops import preprocess as tpre
from pytorch_yolo_tpu_torch.utils.drift import detection_drift
from pytorch_yolo_tpu_torch.utils.profiling import PipelineStats
from tests.torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

SIZE = 320
RNG = np.random.default_rng(0)
MIXED = [RNG.integers(0, 256, (h, w, 3), dtype=np.uint8)
         for h, w in ((480, 640), (300, 500), (640, 480), (123, 777), (416, 416))]


@pytest.fixture(scope="module")
def dets():
    return pj.Detector.load("yolov3-tiny"), pt.Detector.load("yolov3-tiny", device="cpu")


def _agree(ref, ours):
    stats = detection_drift(ref, ours)
    assert len(ref) == len(ours)
    assert stats.ref_dets > 0 and stats.set_agreement == 1.0, stats.row()
    return stats


def _prepared(transfer):
    lbs, geos = [], []
    for im in MIXED[:3]:
        lb, g = tpre.letterbox_host(im, SIZE, out_dtype=transfer)
        lbs.append(lb)
        geos.append([g.scale, g.pad_x, g.pad_y, g.orig_w, g.orig_h])
    return np.stack(lbs), np.asarray(geos, np.float32)


@pytest.mark.parametrize("transfer", ["float32", "uint8"])
def test_detect_prepared_matches_jax(dets, transfer):
    jd, td = dets
    x, geos = _prepared(transfer)
    ref = jd._trim(jd.detect_prepared(x, geos, SIZE), 3)
    res = td.detect_prepared(x, geos, SIZE)
    assert tuple(res.boxes.shape) == (3, 300, 4)
    _agree(ref, td._trim(res, 3))
    assert [k for k in td._pipelines if k.prepared][0].batch == 3


@pytest.mark.parametrize("transfer", ["f32", "u8"])
def test_detect_many_matches_jax(dets, transfer):
    """Mixed source sizes in chunks of 2 (the last padded): one prepared
    pipeline, equal to the JAX package's."""
    jd, td = dets
    ref = jd.detect_many(MIXED, size=SIZE, batch=2, transfer=transfer)
    ours = td.detect_many(MIXED, size=SIZE, batch=2, transfer=transfer)
    _agree(ref, ours)
    assert len([k for k in td._pipelines if k.prepared and k.batch == 2]) == 1
    with pytest.raises(ValueError, match="transfer"):
        td.detect_many(MIXED[:1], transfer="f16")


@pytest.mark.parametrize("host_preproc", [False, True])
def test_detect_stream_matches_jax(dets, host_preproc):
    jd, td = dets
    frames = [MIXED[3], MIXED[3][::-1].copy(), MIXED[3][:, ::-1].copy()]
    ref = list(jd.detect_stream(iter(frames), size=SIZE, host_preproc=host_preproc))
    ours = list(td.detect_stream(iter(frames), size=SIZE, host_preproc=host_preproc, depth=2))
    _agree(ref, ours)
    one = list(td.detect_stream(frames, size=SIZE, depth=1, host_preproc=host_preproc))
    assert [len(d) for d in one] == [len(d) for d in ours]


def test_batch1_int8_pipeline_warns(caplog):
    """Batch-1 int8 is slower than bf16 on the card (chip_smoke.py phase
    15), so building a batch-1 w8a8 pipeline warns, as the JAX package's
    does; batch 2 does not."""
    det = pt.Detector.load("yolov3-tiny", device="cpu", quant="w8a8")
    with caplog.at_level("WARNING", logger="pytorch_yolo_tpu_torch.api"):
        det.warmup([(40, 60)], sizes=(64,), batch=2)
        assert not caplog.records
        det.warmup([(40, 60)], sizes=(64,), batch=1)
    assert ["batch-1" in r.getMessage() for r in caplog.records] == [True]


def test_warmup_builds_the_buckets():
    td = pt.Detector.load("yolov3-tiny", device="cpu")
    td.warmup([(60, 80), (50, 40)], sizes=(64, 96), batch=2)
    keys = {(k.batch, k.orig_h, k.orig_w, k.size) for k in td._pipelines}
    assert keys == {(2, h, w, s) for h, w in ((60, 80), (50, 40)) for s in (64, 96)}


def test_unletterbox_dynamic_matches_jax():
    rng = np.random.default_rng(1)
    boxes = rng.uniform(-50, 450, (3, 20, 4)).astype(np.float32)
    geos = np.asarray([[0.65, 0, 52, 640, 480], [0.832, 0, 0, 500, 300],
                       [1.0, 0.0, 0.0, 1.0, 1.0]], np.float32)
    ref = np.asarray(jpost.unletterbox_boxes_dynamic(jnp.asarray(boxes), jnp.asarray(geos)))
    ours = tpost.unletterbox_boxes_dynamic(torch.from_numpy(boxes), torch.from_numpy(geos))
    np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("h0,w0,size", [(480, 640, 416), (100, 150, 416), (67, 101, 128),
                                        (300, 500, (320, 416))])
def test_cubic_letterbox_matches_jax(h0, w0, size):
    """``letterbox_batch(method="cubic")`` is ``jax.image.resize(cubic)``
    (Keys a = -0.5); ``letterbox_image`` and the host letterbox (cv2's
    INTER_CUBIC, f32 and u8) equal their JAX copies."""
    imgs = np.random.default_rng(h0).integers(0, 256, (2, h0, w0, 3), dtype=np.uint8)
    ref = np.asarray(jpre.letterbox_batch(jnp.asarray(imgs), size=size, method="cubic"))
    ours = tpre.letterbox_batch(torch.from_numpy(imgs), size, method="cubic").numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    one = tpre.letterbox_image(torch.from_numpy(imgs[1]), size, method="cubic", bgr=False)
    np.testing.assert_allclose(one.numpy(), np.asarray(jpre.letterbox_image(
        jnp.asarray(imgs[1]), size, bgr=False, method="cubic")), rtol=0, atol=1e-5)
    for method in ("linear", "cubic"):
        for out_dtype in ("float32", "uint8"):
            a, ga = tpre.letterbox_host(imgs[0], size, method=method, out_dtype=out_dtype)
            b, gb = jpre.letterbox_host(imgs[0], size, method=method, out_dtype=out_dtype)
            assert a.dtype == b.dtype and ga == gb
            np.testing.assert_array_equal(a, b)


def test_cubic_detector_matches_jax():
    ref = pj.Detector.load("yolov3-tiny", interp="cubic").detect_batch(MIXED[1][None], size=SIZE)
    det = pt.Detector.load("yolov3-tiny", device="cpu", interp="cubic")
    _agree(ref, det.detect_batch(MIXED[1][None], size=SIZE))
    with pytest.raises(ValueError, match="interp"):
        pt.Detector.load("yolov3-tiny", device="cpu", interp="area")


def test_checkpoints_load_in_both_packages(dets, tmp_path):
    """A checkpoint the port writes loads in the JAX package and one the
    JAX package writes (Orbax, OCDBT) loads in the port: same params, same
    cfg, same names; the port's detector from the JAX checkpoint detects
    what the original does."""
    jd, td = dets
    td.save_checkpoint(str(tmp_path / "port"))
    jd.save_checkpoint(str(tmp_path / "jax"))
    from_port = pj.Detector.from_checkpoint(str(tmp_path / "port"))
    from_jax = pt.Detector.from_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert from_port.cfg_text == from_jax.cfg_text == td.cfg_text
    assert from_port.class_names == from_jax.class_names == td.class_names
    for i, p in td._fp32_params.items():
        np.testing.assert_array_equal(np.asarray(from_port.params[i]["w"]),
                                      p["w"].transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(from_jax._fp32_params[i]["w"], p["w"])
        np.testing.assert_array_equal(from_jax._fp32_params[i]["b"], p["b"])
    for i, p in jd.params.items():
        np.testing.assert_array_equal(np.asarray(from_port.params[i]["b"]), np.asarray(p["b"]))
    img = MIXED[0][None]
    _agree(td.detect_batch(img, size=SIZE), from_jax.detect_batch(img, size=SIZE))
    # a bf16 detector checkpoints its fp32 host copy; without it, or int8, it refuses
    bf = pt.Detector.load("yolov3-tiny", device="cpu", dtype=torch.bfloat16)
    bf.save_checkpoint(str(tmp_path / "bf16"))
    again = pt.Detector.from_checkpoint(str(tmp_path / "bf16"), device="cpu")
    np.testing.assert_array_equal(again._fp32_params[0]["w"], td._fp32_params[0]["w"])
    with pytest.raises(ValueError, match="fp32"):
        pt.Detector.load("yolov3-tiny", device="cpu", dtype=torch.bfloat16,
                         keep_fp32_params=False).save_checkpoint(str(tmp_path / "x"))
    with pytest.raises(ValueError, match="int8"):
        pt.Detector.load("yolov3-tiny", device="cpu", quant="w8a8").save_checkpoint(
            str(tmp_path / "y"))
    spec = td.spec
    with pytest.raises(ValueError, match="cfg text"):
        pt.Detector(spec, td._fp32_params, device="cpu").save_checkpoint(str(tmp_path / "z"))


def test_zoo_copy_matches_jax(tmp_path):
    assert tzoo.available_models() == jzoo.available_models()
    for name in jzoo.available_models():
        assert tzoo._GENERATORS[name]() == jzoo._GENERATORS[name]()
        assert tzoo._GENERATORS[name](classes=3, width=320, height=256) == \
            jzoo._GENERATORS[name](classes=3, width=320, height=256)
    assert tzoo.TOPOLOGY_PINS == jzoo.TOPOLOGY_PINS
    assert tzoo.model_spec("yolov3-tiny", width=320).net.width == 320
    with pytest.raises(ValueError, match="unknown model"):
        tzoo.model_spec("yolov9")
    tzoo.write_cfg("yolov2-tiny", str(tmp_path / "a.cfg"), classes=20)
    jzoo.write_cfg("yolov2-tiny", str(tmp_path / "b.cfg"), classes=20)
    assert (tmp_path / "a.cfg").read_text() == (tmp_path / "b.cfg").read_text()
    det = pt.Detector.load("yolov2-tiny", device="cpu")
    assert det.cfg_text == jzoo._GENERATORS["yolov2-tiny"]() and det.weights_source is None
    with pytest.raises(ValueError, match="unknown model"):
        pt.Detector.load("yolov9", device="cpu")


@pytest.mark.parametrize("cap", [1, 4, 6, 8, 32])
def test_bucket_ladder_matches_jax(cap):
    assert tserve.bucket_ladder(cap) == jserve.bucket_ladder(cap)


def _png(img, **params):
    ok, buf = cv2.imencode(".png", img, [cv2.IMWRITE_PNG_STRATEGY, params.get("strategy", 0)])
    assert ok
    return buf.tobytes()


def test_decode_png_matches_cv2():
    """The server's stdlib decoder (hosts without OpenCV) against
    ``cv2.imdecode`` on color, gray and alpha PNGs with every row filter."""
    img = np.random.default_rng(2).integers(0, 256, (37, 53, 3), dtype=np.uint8)
    smooth = np.cumsum(np.cumsum(img.astype(np.int64), 0), 1).astype(np.uint8)  # all 5 filters
    for im in (img, smooth, smooth[..., 0], np.dstack([smooth, img[..., :1]])):
        data = _png(im)
        np.testing.assert_array_equal(tserve.decode_png(data),
                                      cv2.imdecode(np.frombuffer(data, np.uint8),
                                                   cv2.IMREAD_COLOR))
    assert tserve.decode_png(b"not a png") is None
    assert tserve.decode_png(_png(img)[:-30]) is None


def test_make_server_answers_like_detect_many(dets):
    """The port's server on a CPU detector: concurrent POSTs of PNGs are
    micro-batched through detect_prepared (uint8 transfer) and answer what
    detect_many gives on the same images; /healthz, /stats and the errors."""
    _, td = dets
    srv = tserve.make_server(td, port=0, size=SIZE, conf=0.5, batch_max=4, batch_timeout_ms=20.0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host, port = srv.server_address[:2]

    def post(data):
        req = urllib.request.Request(f"http://{host}:{port}/detect", data=data, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        imgs = MIXED[:3]
        out = [None] * len(imgs)

        def worker(i):
            out[i] = post(_png(imgs[i]))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(imgs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ref = td.detect_many(imgs, size=SIZE, conf=0.5, transfer="u8")
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(np.asarray(o["boxes"], np.float32).reshape(-1, 4),
                                          r.boxes)
            assert o["cls_id"] == r.cls_id.tolist()
            assert o["names"] == [td.class_names[c] for c in r.cls_id]
        with urllib.request.urlopen(f"http://{host}:{port}/healthz", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(f"http://{host}:{port}/stats", timeout=10) as r:
            assert json.loads(r.read())["items"] == 3
        with pytest.raises(urllib.error.HTTPError) as e:
            post(b"garbage")
        assert e.value.code == 400
    finally:
        srv.batcher.close()
        srv.shutdown()


def test_run_video_matches_detect_stream(dets, tmp_path):
    """run_video on a small cv2-written clip equals detect_stream on the
    same decoded frames, in order, with its stats filled."""
    _, td = dets
    path = str(tmp_path / "clip.avi")
    rng = np.random.default_rng(4)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (160, 120))
    for _ in range(5):
        writer.write(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
    writer.release()
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    assert len(frames) == 5
    stats = PipelineStats()
    seen = []
    results = list(tvideo.run_video(path, td, size=160, conf=0.3, on_result=seen.append,
                                    stats=stats))
    ref = list(td.detect_stream(frames, size=160, conf=0.3))
    assert [r.index for r in results] == list(range(5)) and len(seen) == 5
    for r, d, f in zip(results, ref, frames):
        np.testing.assert_array_equal(r.frame, f)
        np.testing.assert_array_equal(r.detection.boxes, d.boxes)
    assert stats.items == 5 and stats.stages["collect"].summary()["count"] == 5
    assert len(list(tvideo.run_video(path, td, size=160, max_frames=2))) == 2
    with pytest.raises(IOError):
        next(tvideo.run_video(os.path.join(str(tmp_path), "missing.avi"), td))

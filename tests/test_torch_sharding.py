"""The port's batch mesh against the JAX package's, on the CPU.

JAX runs its 8 virtual CPU devices (``tests/conftest.py``); the port's mesh
is 8 entries of the one CPU (4 for the submesh), each entry one shard,
which is how the port runs the split without several cards.  Both get the
same numpy params (each package's ``random_raw_params`` draws the same
numbers) and the same uint8 frames; the JAX detectors run their plain
path, as ``tests/test_sharding.py`` runs them.

Tolerances, each with its reason:
  * the port's mesh against JAX's mesh, those of ``tests/test_sharding.py``:
    boxes rtol 1e-4 / atol 1e-2, ``cls_id`` and counts exact;
  * the port's mesh against the port without a mesh: counts and classes
    exact, boxes and scores within one ulp (``assert_same``: the CPU
    sigmoid's last bits depend on the tensor's length); heads bit for bit
    (the dynamic int8 scale is the whole batch's on both);
  * int8 against JAX: frames at the served size, whose letterbox is the
    identity on both sides.  JAX's resize is a matmul and the port's is
    not; they differ in the last ulp on resized frames, and an ulp can flip
    an int8 rounding (``test_torch_quant.py``: set agreement >= 0.995 on
    480x640 frames).  On resized frames the int8 mesh is held to the port's
    meshless detector.  Static scales come from the JAX
    detector's ``quant_state()``: two fp32 calibration forwards differ in
    their last bits;
  * the forward of the skewed batch (dynamic int8): heads equal bit for bit
    on the port's mesh, JAX's mesh and the port without a mesh;
  * bf16: ``detection_drift`` set agreement >= 0.85 and box p99 <= 2 px,
    the envelope of ``tests/test_sharding.py``'s bf16 cases (the port's
    bf16 conv and XLA's round at other places); the port's mesh is held to
    its meshless detector.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_yolo_tpu as pj
import pytorch_yolo_tpu.cli as jcli
from pytorch_yolo_tpu import serve as jserve
from pytorch_yolo_tpu.models import darknet as jdn
from pytorch_yolo_tpu.models import zoo as jzoo
from pytorch_yolo_tpu.parallel import sharding as jshard
from pytorch_yolo_tpu.weights import fold_batchnorm, random_raw_params
import pytorch_yolo_tpu_torch as pt
import pytorch_yolo_tpu_torch.api as tapi
import pytorch_yolo_tpu_torch.cli as tcli
from pytorch_yolo_tpu_torch import serve as tserve
from pytorch_yolo_tpu_torch import video as tvideo
from pytorch_yolo_tpu_torch.models import darknet as tdn
from pytorch_yolo_tpu_torch.parallel import sharding as tshard
from pytorch_yolo_tpu_torch.utils.drift import detection_drift
from tests.test_new_coords import MINI_P6_CFG
from tests.test_torch_cli import (_coco_set, _jsonl, assert_rows_match,  # noqa: F401
                                  files, run_cli)
from tests.torch_threads import one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

CPU = torch.device("cpu")


def frames(n, shape, seed, high=256):
    return np.stack([np.random.default_rng(seed + i).integers(0, high, shape + (3,),
                                                                dtype=np.uint8)
                     for i in range(n)])


def assert_close(ref, ours):
    """tests/test_sharding.py's bound on each image: counts exact, and each
    of our detections paired with one of ref's of the same class whose box
    is within rtol 1e-4 / atol 1e-2.  Rows are sorted by score, and two
    scores that differ only in their last bits may swap places between
    the two packages."""
    assert len(ref) == len(ours)
    assert sum(len(d) for d in ref) > 0
    for a, b in zip(ref, ours):
        assert len(a) == len(b)
        free = list(range(len(a)))
        for box, cls in zip(b.boxes, b.cls_id):
            hit = next(k for k in free if a.cls_id[k] == cls and np.all(
                np.abs(box - a.boxes[k]) <= 1e-2 + 1e-4 * np.abs(a.boxes[k])))
            free.remove(hit)


def assert_same(ref, ours):
    """The port without a mesh and with one: counts and classes exact,
    boxes and scores within one ulp.  On the CPU, K1's plain version runs
    torch's vectorized sigmoid, whose scalar tail rounds differently from
    its vector body, and where the tail falls depends on the tensor's
    length: a shard of one image against a batch of eight (K1 on the card
    decodes each row alone)."""
    assert len(ref) == len(ours)
    for a, b in zip(ref, ours):
        np.testing.assert_array_equal(b.cls_id, a.cls_id)
        for f in ("boxes", "obj", "cls_score"):
            np.testing.assert_array_max_ulp(getattr(b, f), getattr(a, f), maxulp=1)


def host(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _json(state):
    return json.loads(json.dumps(state))  # through the file format: str keys


def revive(state, **kw):
    """A port detector serving a JAX detector's int8 state."""
    return pt.Detector.load("yolov3-tiny", quant="w8a8", quant_act_scales=state["scales"],
                            quant_skip_layers=frozenset(state["skip"]),
                            quant_bias_delta=state.get("bias_delta"), **kw)


@pytest.fixture(scope="module")
def jmesh():
    assert jax.device_count() == 8, "conftest must force 8 CPU devices"
    return jshard.make_batch_mesh()


@pytest.fixture(scope="module")
def tmesh():
    return tshard.make_batch_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def tiny(jmesh, tmesh):
    """yolov3-tiny at fp32: JAX on its mesh, the port on its mesh and
    without one."""
    return (pj.Detector.load("yolov3-tiny", mesh=jmesh),
            pt.Detector.load("yolov3-tiny", mesh=tmesh),
            pt.Detector.load("yolov3-tiny", device="cpu"))


@pytest.fixture(scope="module")
def dynamic(jmesh, tmesh):
    """yolov3-tiny, W8A8 with dynamic scales on every conv, the heads too:
    the same three.  Each int8 conv's sums are exact on both sides, so the
    forward gives the same bits at any batch; an fp32 head conv would not
    (the CPU's conv blocks its sums by the batch's shape)."""
    kw = dict(quant="w8a8", quant_skip_layers=())
    return (pj.Detector.load("yolov3-tiny", mesh=jmesh, **kw),
            pt.Detector.load("yolov3-tiny", mesh=tmesh, **kw),
            pt.Detector.load("yolov3-tiny", device="cpu", **kw))


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_mesh_shape(tmesh, jmesh):
    assert tmesh.size == jmesh.devices.size == 8
    assert jmesh.axis_names == (tshard.BATCH_AXIS,) == ("batch",)
    assert tmesh.devices == (CPU,) * 8
    assert tshard.make_batch_mesh(["cpu:0", torch.device("cpu")]).devices == (CPU, CPU)


def test_mesh_refusals():
    """No card is taken where there is none, an entry past the local cards
    raises, and a device that contradicts the mesh raises."""
    with pytest.raises(ValueError, match="at least one"):
        tshard.make_batch_mesh([])
    with pytest.raises(ValueError, match="cpu and cuda"):
        tshard.make_batch_mesh(["meta"])
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"only {count} local CUDA"):
        tshard.make_batch_mesh([f"cuda:{count}"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tshard.make_batch_mesh()
    with pytest.raises(ValueError, match="contradicts the mesh"):
        pt.Detector.load("yolov3-tiny", device="cuda:0",
                         mesh=tshard.make_batch_mesh(["cpu"] * 2))


def test_pad_to_multiple():
    assert tshard.pad_to_multiple(1, 8) == 8
    assert tshard.pad_to_multiple(8, 8) == 8
    assert tshard.pad_to_multiple(9, 8) == 16
    for n in range(1, 20):
        for m in (1, 3, 4, 8):
            assert tshard.pad_to_multiple(n, m) == jshard.pad_to_multiple(n, m)


def test_shard_batch_placement(tmesh):
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    for arr in (x, torch.from_numpy(x)):
        shards = tshard.shard_batch(arr, tmesh)
        assert len(shards) == 8 and {s.shape for s in shards} == {(1, 4)}  # one row a shard
        assert all(s.device == CPU and s.is_contiguous() for s in shards)
        np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    with pytest.raises(ValueError, match="does not divide the mesh size 8"):
        tshard.shard_batch(x[:5], tmesh)


def test_replicated_params(tmesh, tiny):
    """Repeated entries share one replica; the detector's model is the
    first."""
    lin = torch.nn.Linear(3, 3)
    rep = tshard.replicate_params(lin, tmesh)
    assert len(rep) == 8 and all(r is lin for r in rep)
    _, det, _ = tiny
    assert len(det._replicas) == 8 and all(r is det.model for r in det._replicas)
    two = tshard.make_batch_mesh(["cpu", "cpu"])
    assert tshard.gather_batch([torch.ones(1, 2), torch.zeros(1, 2)], CPU).shape == (2, 2)
    assert len(set(map(id, tshard.replicate_params(lin, two)))) == 1


# ---------------------------------------------------------------------------
# detections on the mesh
# ---------------------------------------------------------------------------


def test_sharded_detector_matches_single_device(tiny):
    jd, td, single = tiny
    imgs = frames(8, (320, 320), 0)
    ours = td.detect_batch(imgs, conf=0.3)
    assert len(ours) == 8
    assert_close(jd.detect_batch(imgs, conf=0.3), ours)
    assert_same(single.detect_batch(imgs, conf=0.3), ours)


def test_mesh_of_one_device(tiny):
    """A mesh of one entry is the detector without a mesh."""
    _, _, single = tiny
    one = pt.Detector.load("yolov3-tiny", mesh=tshard.make_batch_mesh(["cpu"]))
    imgs = frames(3, (240, 320), 3)
    assert_same(single.detect_batch(imgs, size=320, conf=0.3),
                 one.detect_batch(imgs, size=320, conf=0.3))


def test_sharded_detector_pads_ragged_batch(tiny):
    jd, td, single = tiny
    imgs = frames(5, (320, 320), 1)
    res = td.detect_batch(imgs, conf=0.3)
    assert len(res) == 5  # padding rows trimmed
    assert [k.batch for k in td._pipelines] == [8] * len(td._pipelines)
    assert_close(jd.detect_batch(imgs, conf=0.3), res)
    assert_same(single.detect_batch(imgs, conf=0.3), res)


def test_pipelines_ran_on_their_entries(tiny, monkeypatch):
    """The port's stand-in for "the output is batch-sharded": every layer
    and K1 ran once a shard on a batch of one, the result is gathered on
    the mesh's first device, and ``raw_result`` keeps JAX's refusal of a
    batch that does not divide the mesh."""
    jd, td, _ = tiny
    seen, decoded = [], []
    decode = tapi.decode_score_all

    def counting(heads, spec, **kw):
        decoded.append(heads[0].shape[0])
        return decode(heads, spec, **kw)

    monkeypatch.setattr(tapi, "decode_score_all", counting)
    td.model.layer_hook = lambda i, x: seen.append((i, x.shape[0], x.device))
    try:
        res = td.raw_result(np.zeros((8, 320, 320, 3), np.uint8), size=320, conf=0.5)
    finally:
        td.model.layer_hook = None
    layers = len(td.spec.layers)
    assert len(seen) == 8 * layers and {(b, d) for _, b, d in seen} == {(1, CPU)}
    assert [i for i, _, _ in seen[:8]] == [0] * 8  # in lockstep: layer 0 on every shard first
    assert decoded == [1] * 8
    assert tuple(res.boxes.shape) == (8, 300, 4) and res.boxes.device == CPU
    for det in (jd, td):
        with pytest.raises(ValueError, match="raw_result batch 5 must divide the mesh size 8"):
            det.raw_result(np.zeros((5, 320, 320, 3), np.uint8))
    with pytest.raises(ValueError, match="detect_prepared batch 5 must divide"):
        td.detect_prepared(np.zeros((5, 320, 320, 3), np.float32),
                           np.tile([[1.0, 0, 0, 1, 1]], (5, 1)), 320)


def test_submesh_of_four():
    """Detector on a 4-entry submesh, against JAX's on 4 devices."""
    imgs = frames(6, (256, 256), 2)
    jd = pj.Detector.load("yolov3-tiny", mesh=jshard.make_batch_mesh(jax.devices()[:4]))
    td = pt.Detector.load("yolov3-tiny", mesh=tshard.make_batch_mesh(["cpu"] * 4))
    res = td.detect_batch(imgs, size=256, conf=0.5)  # pads 6 -> 8
    assert len(res) == 6 and {k.batch for k in td._pipelines} == {8}
    assert_close(jd.detect_batch(imgs, size=256, conf=0.5), res)


def test_quantized_detector_on_mesh(dynamic):
    """Dynamic W8A8 on the mesh: JAX's on frames at the served size, the
    port's meshless detector on resized frames."""
    jd, td, single = dynamic
    imgs = frames(8, (160, 160), 0)
    assert_close(jd.detect_batch(imgs, size=160, conf=0.4), td.detect_batch(imgs, size=160,
                                                                              conf=0.4))
    big = frames(8, (200, 300), 0)
    assert_same(single.detect_batch(big, size=160, conf=0.4),
                td.detect_batch(big, size=160, conf=0.4))


def skewed_batch() -> np.ndarray:
    """Eight frames at 160x160: frame 3 spans the whole range [0, 1], the
    other seven are dim (below 24/255)."""
    x = frames(8, (160, 160), 50, high=24)
    x[3] = frames(1, (160, 160), 9)[0]
    return x


def test_whole_batch_dynamic_scale(dynamic, jmesh, tmesh):
    """The dynamic int8 scale of a mesh is the whole batch's: on a skewed
    batch the shards' own maxima differ at the first int8 conv, yet the
    port's mesh gives the heads of JAX's mesh and of the port without a
    mesh bit for bit, and the detections of the latter.  A scale taken
    shard by shard gives other heads."""
    jd, td, single = dynamic
    imgs = skewed_batch()
    x = imgs.astype(np.float32) / np.float32(255.0)  # the identity letterbox of 160 frames
    first = min(map(int, td.model.qconvs))
    local = [float(td.model(s, collect_conv_in_stats=lambda i, v: v.abs().amax() if i == first
                            else None)[1][first]) for s in tshard.shard_batch(x, tmesh)]
    assert len(set(local)) > 1 and max(local) == 1.0 and min(local) < 24 / 255

    assert not td.model.convs  # every conv int8
    jheads = jax.jit(jdn.build_forward(jd.spec, quant="w8a8"))(
        jd.params, jax.device_put(x, jshard.batch_sharding(jmesh)))
    shards = tshard.shard_batch(x, tmesh)
    mesh_heads = [torch.cat(h) for h in zip(*tdn.Darknet.forward_mesh(td._replicas, shards))]
    one_heads = single.model(torch.from_numpy(x))
    per_shard = [torch.cat(h) for h in zip(*(td.model(s) for s in shards))]
    for ours, ref, one, alone in zip(mesh_heads, jheads, one_heads, per_shard):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(ours.numpy(), one.numpy())
        assert not torch.equal(alone, ours)  # the test sees a per-shard scale

    ours = td.detect_batch(imgs, size=160, conf=0.3)
    assert_same(single.detect_batch(imgs, size=160, conf=0.3), ours)
    assert_close(jd.detect_batch(imgs, size=160, conf=0.3), ours)


def _jax_int8(jmesh, **kw):
    """A calibrated JAX int8 detector on one device, its copy on the JAX
    mesh (pre-quantized params adopted, as tests/test_sharding.py builds
    it) and its JSON state."""
    single = pj.Detector.load("yolov3-tiny", quant="w8a8", **kw)
    mesh_kw = {k: v for k, v in kw.items() if k in ("compute_dtype", "precision")}
    on_mesh = pj.Detector(single.spec, {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                                        for k, v in single.params.items()},
                          mesh=jmesh, **mesh_kw)
    return on_mesh, _json(single.quant_state())


@pytest.mark.parametrize("smooth", [None, 0.5], ids=["static_resident", "smoothed"])
def test_static_int8_on_mesh(jmesh, tmesh, smooth):
    """Static int8 with int8-resident chains, and per-channel smoothed
    grids (vector ``sa``), on the mesh: the JAX state served by the port's
    mesh gives JAX's mesh detections."""
    rng = np.random.default_rng(5 if smooth is None else 11)
    calib = [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8) for _ in range(2)]
    kw = {"quant_calib": calib, "quant_calib_size": 160}
    if smooth is not None:
        kw.update(quant_smooth=smooth, quant_recipe="none")
    jd, state = _jax_int8(jmesh, **kw)
    td = revive(state, mesh=tmesh)
    assert td.model._chains and td.model._dynamic == frozenset()
    if smooth is not None:
        assert any(isinstance(v, dict) for v in state["scales"].values())
    imgs = frames(8, (160, 160), 100)
    assert_close(jd.detect_batch(imgs, size=160, conf=0.4), td.detect_batch(imgs, size=160,
                                                                              conf=0.4))


def _drift_ok(ref, ours):
    stats = detection_drift(ref, ours)
    assert stats.ref_dets > 0 and stats.set_agreement >= 0.85, stats.row()
    assert stats.box_p99_px <= 2.0, stats.row()


def test_bf16_serving_on_mesh(jmesh, tmesh):
    """bf16 serving (every fp conv on K5's plain version) on the mesh."""
    jd = pj.Detector.load("yolov3-tiny", compute_dtype=jnp.bfloat16, precision="default",
                          mesh=jmesh)
    kw = dict(dtype=torch.bfloat16, precision="default")
    td = pt.Detector.load("yolov3-tiny", mesh=tmesh, **kw)
    single = pt.Detector.load("yolov3-tiny", device="cpu", **kw)
    imgs = frames(8, (240, 320), 2)
    ours = td.detect_batch(imgs, size=320, conf=0.2)
    for b in ours:
        assert b.boxes.shape[1:] == (4,) and np.isfinite(b.boxes).all()
        assert ((b.cls_id >= 0) & (b.cls_id < 80)).all()
    assert_same(single.detect_batch(imgs, size=320, conf=0.2), ours)
    _drift_ok(jd.detect_batch(imgs, size=320, conf=0.2), ours)


def test_int8sb_serving_mode_on_mesh(jmesh, tmesh):
    """int8 convs with bf16 glue and the early skip on the mesh: the JAX
    state served by the port's mesh against JAX's mesh, and the port's
    meshless detector on the same state."""
    rng = np.random.default_rng(9)
    calib = [rng.integers(0, 256, (96, 128, 3), dtype=np.uint8) for _ in range(2)]
    bf = dict(compute_dtype=jnp.bfloat16, precision="default")
    jd, state = _jax_int8(jmesh, quant_calib=calib, quant_calib_size=160, **bf)
    kw = dict(dtype=torch.bfloat16, precision="default")
    td, single = revive(state, mesh=tmesh, **kw), revive(state, device="cpu", **kw)
    assert td.model.qconvs and td.model.convs  # int8 convs, bf16 head convs (K5)
    imgs = frames(8, (160, 160), 3)
    ours = td.detect_batch(imgs, size=160, conf=0.2)
    assert_same(single.detect_batch(imgs, size=160, conf=0.2), ours)
    _drift_ok(jd.detect_batch(imgs, size=160, conf=0.2), ours)


def _pair(name_or_cfg, jmesh, tmesh):
    spec = jzoo.model_spec(name_or_cfg) if not name_or_cfg.endswith(".cfg") else None
    jd = (pj.Detector(spec, host(fold_batchnorm(spec, random_raw_params(spec))), mesh=jmesh)
          if spec is not None else pj.Detector.load(name_or_cfg, mesh=jmesh))
    return jd, pt.Detector.load(name_or_cfg, mesh=tmesh)


def test_yolov4_tiny_on_mesh(jmesh, tmesh):
    """The CSP split routes on the mesh."""
    jd, td = _pair("yolov4-tiny", jmesh, tmesh)
    imgs = frames(8, (96, 128), 4)
    assert_close(jd.detect_batch(imgs, size=96, conf=0.3), td.detect_batch(imgs, size=96,
                                                                             conf=0.3))


@pytest.mark.parametrize("head", ["stride64", "stride128"])
def test_deep_heads_on_mesh(jmesh, tmesh, tmp_path, head):
    """The mini-P6 cfg (4 anchors, a stride-64 head) and the mini-P7 cfg
    (a stride-128 head, input 128) on the mesh, as tests/test_sharding.py
    derives them."""
    text, size, shape = MINI_P6_CFG, 64, (96, 128)
    if head == "stride128":
        text = MINI_P6_CFG.replace(
            "[convolutional]\nfilters=340",
            "[convolutional]\nbatch_normalize=1\nfilters=16\nsize=3\nstride=2\n"
            "pad=1\nactivation=mish\n\n[convolutional]\nfilters=340")
        text = text.replace("width=64", "width=128").replace("height=64", "height=128")
        size, shape = 128, (96, 160)
    cfg = tmp_path / f"mini-{head}.cfg"
    cfg.write_text(text)
    jd, td = _pair(str(cfg), jmesh, tmesh)
    imgs = frames(8, shape, 11)
    assert_close(jd.detect_batch(imgs, size=size, conf=0.05),
                 td.detect_batch(imgs, size=size, conf=0.05))


MIXED = [np.random.default_rng(31).integers(0, 256, (h, w, 3), dtype=np.uint8)
         for h, w in ((200, 320), (240, 180), (160, 160), (300, 220), (220, 300))]


def test_detect_many_on_mesh(tiny):
    """detect_many (host letterbox -> prepared pipeline, each shard staged to
    its entry) on the mesh; a chunk of 3 is padded to the mesh as well."""
    jd, td, single = tiny
    ours = td.detect_many(MIXED, size=320, conf=0.3, batch=8)
    assert len(ours) == 5
    assert_close(jd.detect_many(MIXED, size=320, conf=0.3, batch=8), ours)
    assert_same(single.detect_many(MIXED, size=320, conf=0.3, batch=8), ours)
    assert_same(ours, td.detect_many(MIXED, size=320, conf=0.3, batch=3, transfer="f32"))


@pytest.mark.parametrize("host_preproc", [False, True])
def test_detect_stream_on_mesh(tiny, host_preproc):
    """Batch-1 dispatches padded to the mesh, the results trimmed to 1."""
    jd, td, single = tiny
    imgs = list(frames(3, (200, 320), 41))
    kw = dict(size=320, conf=0.3, host_preproc=host_preproc)
    ours = list(td.detect_stream(iter(imgs), **kw))
    assert len(ours) == 3
    assert_close(list(jd.detect_stream(iter(imgs), **kw)), ours)
    assert_same(list(single.detect_stream(iter(imgs), **kw)), ours)


def test_run_video_on_mesh(tiny, tmp_path):
    jd, td, _ = tiny
    from pytorch_yolo_tpu.video import run_video

    src = str(tmp_path / "clip.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (320, 240))
    for f in frames(4, (240, 320), 6):
        w.write(f)
    w.release()
    a = list(run_video(src, jd, size=320, conf=0.4))
    b = list(tvideo.run_video(src, td, size=320, conf=0.4))
    assert [r.index for r in a] == [r.index for r in b] == [0, 1, 2, 3]
    assert_close([r.detection for r in a], [r.detection for r in b])


def test_warmup_builds_the_mesh_pipelines(tmesh):
    td = pt.Detector.load("yolov3-tiny", mesh=tmesh)
    td.warmup([(60, 80)], sizes=(64,), batch=3)
    assert {(k.batch, k.size) for k in td._pipelines} == {(8, 64)}


# ---------------------------------------------------------------------------
# the server and the command line
# ---------------------------------------------------------------------------


def test_serve_on_mesh_buckets_divide_mesh():
    """A mesh-bound detector floors the micro-batch buckets at the mesh
    size and rounds batch_max up to it, and answers as detect_many does."""
    import threading
    import urllib.request

    det = pt.Detector.load("yolov3-tiny", mesh=tshard.make_batch_mesh(["cpu"] * 4))
    srv = tserve.make_server(det, port=0, size=320, conf=0.5, batch_max=6,
                             batch_timeout_ms=10.0)
    try:
        assert srv.batcher.bucket_floor == 4
        assert srv.batcher.batch_max == 8  # 6 rounded up to a mesh multiple
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        img = frames(1, (240, 320), 3)[0]
        ok, png = cv2.imencode(".png", img)
        assert ok
        host_, port = srv.server_address[:2]
        req = urllib.request.Request(f"http://{host_}:{port}/detect", data=png.tobytes(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        lib = det.detect_many([img], size=320, conf=0.5, transfer="u8")[0]
        assert len(body["boxes"]) == len(lib) > 0
        np.testing.assert_allclose(np.asarray(body["boxes"]), lib.boxes, rtol=1e-4, atol=1e-2)
    finally:
        srv.batcher.close()
        srv.shutdown()


def test_mesh_bucket_math_matches_jax():
    """Buckets on a 3-entry mesh are always multiples of 3 and the warmup
    ladder is exactly the dispatchable set, as JAX's."""
    cap = 9  # batch_max already rounded to a floor multiple
    for n in range(1, cap + 1):
        b = tserve._mesh_bucket(n, cap, 3)
        assert b % 3 == 0 and n <= b <= cap and b == jserve._mesh_bucket(n, cap, 3)
    assert tserve.bucket_ladder(cap, 3) == [3, 6, 9]
    assert tserve.bucket_ladder(8, 1) == tserve.bucket_ladder(8) == [1, 2, 4, 8]
    for cap, floor in ((8, 2), (12, 4), (16, 8), (24, 3)):
        assert tserve.bucket_ladder(cap, floor) == jserve.bucket_ladder(cap, floor)


@pytest.fixture
def cpu_cards(monkeypatch):
    """The command line's local devices named as the CPU four times."""
    monkeypatch.setattr(tcli, "_local_devices", lambda device: [CPU] * 4)


def test_cli_detect_sharded_over_mesh(files, tmp_path, cpu_cards):
    """detect --devices 4 builds the mesh inside the CLI: the detections of
    --devices 1 and of JAX's --devices 4, at test_torch_cli.py's bound
    (ids exact, 2-decimal boxes and 4-decimal scores within one rounding
    step)."""
    outs = {}
    for name, main, n, extra in (("t1", tcli.main, 1, ["--device", "cpu"]),
                                 ("t4", tcli.main, 4, ["--device", "cpu"]),
                                 ("j4", jcli.main, 4, ["--no-compile-cache"])):
        out = str(tmp_path / name)
        assert main(["detect", "--images", files["imgs"], "--det", out, "--cfg", files["cfg"],
                     "--weights", files["weights"], "--reso", "160", "--devices", str(n),
                     "--save-json", *extra]) == 0
        outs[name] = sorted(_jsonl(os.path.join(out, "detections.jsonl")),
                            key=lambda r: r["image"])
    assert len(outs["t4"]) == 3
    assert_rows_match(outs["t4"], outs["t1"])
    assert_rows_match(outs["t4"], outs["j4"])


def test_cli_batch_rounded_to_the_mesh(files, tmp_path, cpu_cards, caplog):
    """--devices 3 --batch 8: --batch is rounded up to 9 with JAX's log line,
    and the run writes every image."""
    out = str(tmp_path / "det_m3")
    with caplog.at_level("INFO", logger="pytorch_yolo_tpu_torch"):
        assert tcli.main(["detect", "--images", files["imgs"], "--det", out, "--cfg",
                          files["cfg"], "--weights", files["weights"], "--reso", "160",
                          "--devices", "3", "--batch", "8", "--device", "cpu"]) == 0
    assert "sharding batches over 3 devices" in caplog.text
    assert "rounded --batch 8 up to 9 (multiple of 3 mesh devices)" in caplog.text
    assert sorted(os.listdir(out)) == ["det_im0.png", "det_im1.png", "det_im2.png"]
    with pytest.raises(SystemExit, match=r"--devices 5: only 4 local device\(s\) available"):
        tcli._build_detector(tcli.build_parser().parse_args(
            ["detect", "--images", files["imgs"], "--cfg", files["cfg"], "--device", "cpu",
             "--devices", "5"]))
    det = tcli._build_detector(tcli.build_parser().parse_args(
        ["detect", "--images", files["imgs"], "--cfg", files["cfg"], "--device", "cpu",
         "--devices", "0", "--debug-nans"]))
    assert det.mesh.size == 4 and det.model.layer_hook is tcli._raise_on_nonfinite


def test_cli_evaluate_on_mesh(files, tmp_path, cpu_cards, capsys):
    """evaluate --devices 4 (detect_many chunks over the mesh) reports the
    metrics of --devices 1 exactly, and JAX's --devices 4."""
    rows = _jsonl_rows(files, tmp_path)
    ann = str(tmp_path / "instances.json")
    _coco_set(files, rows, ann)
    argv = ["evaluate", "--cfg", files["cfg"], "--weights", files["weights"], "--images",
            files["imgs"], "--annotations", ann, "--reso", "160", "--batch", "2"]
    metrics = {n: json.loads(run_cli(tcli.main, argv + ["--device", "cpu", "--devices", n],
                                     capsys).strip().splitlines()[-1]) for n in ("1", "4")}
    ref = json.loads(run_cli(jcli.main, argv + ["--no-compile-cache", "--devices", "4"],
                             capsys).strip().splitlines()[-1])
    assert metrics["1"]["images"] == metrics["4"]["images"] == ref["images"] == 3
    for key in ("mAP@0.5", "AP@[.5:.95]", "AP75"):
        assert metrics["1"][key] == metrics["4"][key]
        assert abs(metrics["4"][key] - ref[key]) <= 1e-9, key


def _jsonl_rows(files, tmp_path):
    out = str(tmp_path / "rows")
    assert tcli.main(["detect", "--images", files["imgs"], "--det", out, "--cfg", files["cfg"],
                      "--weights", files["weights"], "--reso", "160", "--save-json",
                      "--device", "cpu"]) == 0
    return _jsonl(os.path.join(out, "detections.jsonl"))


def test_cli_profile_on_mesh(files, cpu_cards, capsys):
    """profile on a mesh times the first replica with the whole batch, and
    says so."""
    capsys.readouterr()
    assert tcli.main(["profile", "--pipeline", "--cfg", files["cfg"], "--reso", "64", "--batch",
                      "3", "--iters", "1", "--device", "cpu", "--devices", "2"]) == 0
    out, err = capsys.readouterr()
    assert [r["stage"] for r in json.loads(out)] == ["letterbox", "+forward", "+decode", "+nms"]
    assert "the first replica (cpu) with the whole batch of 4" in err

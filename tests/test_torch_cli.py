"""The port's command line against the JAX package's, on the same files.

Both CLIs run in this process on the CPU (``--device cpu`` for the port;
the JAX side as its own tests run it): yolov3-tiny from an exported .cfg,
one ``.weights`` file written by the port's writer, PNG images.

Tolerances: ``detect``'s ids, names and keep sets exactly, its 2-decimal
boxes within 0.01 and 4-decimal scores within 1e-4 (one rounding step:
two fp32 convolutions differ in the last bits); ``evaluate``'s printed
mAP@0.5, AP@[.5:.95] and AP75 within 1e-9; ``--save-dets`` arrays of equal
keys, shapes and classes, boxes within 1e-3 px and scores within 1e-5;
``info`` text and ``export-cfg`` files equal; int8 scale files within
1e-6 with the same skip set.
"""

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import pytorch_yolo_tpu.cli as jcli
import pytorch_yolo_tpu_torch as pt
import pytorch_yolo_tpu_torch.cli as tcli
import pytorch_yolo_tpu_torch.serve as tserve
import pytorch_yolo_tpu_torch.weights as tw
from pytorch_yolo_tpu_torch.serve import decode_png, encode_png
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBCOMMANDS = ("detect", "video", "evaluate", "serve", "profile", "info", "export-cfg", "assets")


def run_cli(main, argv, capsys) -> str:
    """main(argv) -> its standard output (asserting exit code 0)."""
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tcli")
    cfg, weights = str(d / "tiny.cfg"), str(d / "tiny.weights")
    pt.write_cfg("yolov3-tiny", cfg)
    spec = pt.model_spec("yolov3-tiny")
    tw.write_weights_file(spec, tw.random_raw_params(spec, seed=0), weights)
    rng = np.random.default_rng(0)
    imgs, calib = d / "imgs", d / "calib"
    imgs.mkdir()
    calib.mkdir()
    for i, shape in enumerate([(120, 160), (240, 320), (240, 320)]):
        (imgs / f"im{i}.png").write_bytes(
            encode_png(rng.integers(0, 256, shape + (3,), dtype=np.uint8)))
    for i in range(2):
        (calib / f"c{i}.png").write_bytes(
            encode_png(rng.integers(0, 256, (200, 260, 3), dtype=np.uint8)))
    return {"dir": d, "cfg": cfg, "weights": weights, "imgs": str(imgs), "calib": str(calib)}


def _jsonl(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def detect_runs(files):
    """detections.jsonl of both CLIs at a square and a rectangular --reso."""
    out = {}
    for reso in ("160", "128x192"):
        for name, main, extra in (("torch", tcli.main, ["--device", "cpu"]),
                                  ("jax", jcli.main, ["--no-compile-cache"])):
            det = str(files["dir"] / f"det_{name}_{reso}")
            assert main(["detect", "--cfg", files["cfg"], "--weights", files["weights"],
                         "--images", files["imgs"], "--det", det, "--reso", reso, "--batch",
                         "2", "--save-json", *extra]) == 0
            out[name, reso] = (det, _jsonl(os.path.join(det, "detections.jsonl")))
    return out


def steps_apart(a, b, decimals: int) -> int:
    """The most rounding steps between two lists of values printed to
    ``decimals`` places (their float32 forms are not exact decimals)."""
    scale = 10.0 ** decimals
    return int(np.abs(np.round(np.asarray(a, np.float64) * scale)
                      - np.round(np.asarray(b, np.float64) * scale)).max(initial=0))


def assert_rows_match(ours, ref):
    assert [r["image"] for r in ours] == [r["image"] for r in ref]
    assert sum(len(r["cls_id"]) for r in ref) >= 5
    for a, b in zip(ours, ref):
        assert a["cls_id"] == b["cls_id"] and a["names"] == b["names"]
        assert steps_apart(a["boxes"], b["boxes"], 2) <= 1  # within 0.01
        for key in ("obj", "cls_score"):
            assert steps_apart(a[key], b[key], 4) <= 1  # within 1e-4


@pytest.mark.parametrize("reso", ["160", "128x192"])
def test_detect_matches_jax(detect_runs, reso):
    (tdir, ours), (jdir, ref) = detect_runs["torch", reso], detect_runs["jax", reso]
    assert_rows_match(ours, ref)
    drawn = sorted(f for f in os.listdir(tdir) if f.startswith("det_"))
    assert drawn == sorted(f for f in os.listdir(jdir) if f.startswith("det_"))
    assert cv2.imread(os.path.join(tdir, drawn[1])).shape == (240, 320, 3)


def test_detect_without_opencv(files, detect_runs, tmp_path, monkeypatch):
    """Without cv2 (as on the card's machine) detect reads the PNGs with the
    standard library and writes PNGs it decodes; the detections are the
    ones the cv2 run gave."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    det = str(tmp_path / "det")
    assert tcli.main(["detect", "--cfg", files["cfg"], "--weights", files["weights"],
                      "--images", files["imgs"], "--det", det, "--reso", "160",
                      "--save-json", "--device", "cpu"]) == 0
    assert _jsonl(os.path.join(det, "detections.jsonl")) == detect_runs["torch", "160"][1]
    for name in ("det_im0.png", "det_im1.png", "det_im2.png"):
        with open(os.path.join(det, name), "rb") as f:
            assert decode_png(f.read()).shape[2] == 3


def _coco_set(files, rows, path):
    """A COCO set over the images: the port's detections jittered, random
    boxes and crowds, sparse category ids."""
    rng = np.random.default_rng(7)
    ids = (1, 2, 3, 5, 7, 90) + tuple(range(100, 174))  # 80 sparse ids
    coco = {"images": [], "annotations": [], "categories": [{"id": c} for c in ids]}
    for i, r in enumerate(rows):
        name = os.path.basename(r["image"])
        h, w = cv2.imread(os.path.join(files["imgs"], name)).shape[:2]
        coco["images"].append({"id": 10 + i, "file_name": name, "width": w, "height": h})
        boxes = np.reshape(r["boxes"], (-1, 4))[:12]
        for (x1, y1, x2, y2), c in zip(boxes, r["cls_id"]):
            j = rng.normal(0, 2, 4)
            coco["annotations"].append({"id": len(coco["annotations"]), "image_id": 10 + i,
                                        "category_id": ids[c], "iscrowd": 0,
                                        "bbox": [x1 + j[0], y1 + j[1], x2 - x1 + j[2],
                                                 y2 - y1 + j[3]]})
        for k in range(4):
            x, y = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            coco["annotations"].append({"id": len(coco["annotations"]), "image_id": 10 + i,
                                        "category_id": int(rng.choice(ids[:6])),
                                        "iscrowd": int(k == 0),
                                        "bbox": [x, y, rng.uniform(8, w / 2),
                                                 rng.uniform(8, h / 2)]})
    with open(path, "w", encoding="utf-8") as f:
        json.dump(coco, f)


def test_evaluate_matches_jax(files, detect_runs, tmp_path, capsys):
    ann = str(tmp_path / "instances.json")
    _coco_set(files, detect_runs["torch", "160"][1], ann)
    argv = ["evaluate", "--cfg", files["cfg"], "--weights", files["weights"], "--images",
            files["imgs"], "--annotations", ann, "--reso", "160", "--batch", "2"]
    ours = json.loads(run_cli(tcli.main, argv + ["--device", "cpu", "--save-dets",
                                                 str(tmp_path / "t.npz")], capsys))
    ref = json.loads(run_cli(jcli.main, argv + ["--no-compile-cache", "--save-dets",
                                                str(tmp_path / "j.npz")], capsys))
    assert 0.0 < ref["mAP@0.5"] < 1.0 and ours["images"] == ref["images"] == 3
    for key in ("mAP@0.5", "AP@[.5:.95]", "AP75"):
        assert abs(ours[key] - ref[key]) <= 1e-9, key
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files) and int(t["n_images"]) == 3
        for i in range(3):
            assert_same_detections(*(
                [(b, s, c) for b, s, c in zip(z[f"boxes_{i}"], z[f"scores_{i}"],
                                              z[f"classes_{i}"])] for z in (t, j)))


def assert_same_detections(ours: list, ref: list):
    """Equal sets of (box, score, class): each of ours pairs with one of
    ref's of the same class, box within 1e-3 px and score within 1e-5.
    The order may differ where two scores differ only in their last bits
    (the rows are sorted by score)."""
    assert len(ours) == len(ref) > 0
    free = list(range(len(ref)))
    for box, score, cls in ours:
        hit = next(k for k in free if ref[k][2] == cls and abs(ref[k][1] - score) <= 1e-5
                   and np.abs(ref[k][0] - box).max() <= 1e-3)
        free.remove(hit)


@pytest.mark.parametrize("int8_plan", [False, True])
@pytest.mark.parametrize("source", [("--cfg", os.path.join(ROOT, "cfg", "yolov3.cfg")),
                                    ("--model", "yolov4-tiny")])
def test_info_matches_jax(source, int8_plan, capsys):
    argv = ["info", *source] + (["--int8-plan"] if int8_plan else [])
    assert run_cli(tcli.main, argv, capsys) == run_cli(jcli.main, argv, capsys)


@pytest.mark.parametrize("name", pt.available_models())
def test_export_cfg_matches_jax(name, tmp_path):
    ours, ref = str(tmp_path / "t.cfg"), str(tmp_path / "j.cfg")
    assert tcli.main(["export-cfg", "--model", name, "--out", ours]) == 0
    assert jcli.main(["export-cfg", "--model", name, "--out", ref]) == 0
    with open(ours, "rb") as f, open(ref, "rb") as g:
        assert f.read() == g.read()


def _jax_parser(monkeypatch) -> argparse.ArgumentParser:
    """The parser the JAX main builds, taken as it parses."""
    class Got(Exception):
        pass

    def grab(self, *args, **kwargs):
        raise Got(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(Got) as got:
        jcli.main([])
    monkeypatch.undo()
    return got.value.args[0]


def _options(parser) -> dict:
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {s for a in p._actions for s in a.option_strings} | {
                a.dest for a in p._actions if not a.option_strings}
            for name, p in sub.choices.items()}


def test_parser_has_every_jax_option(monkeypatch):
    """Every subcommand and option string of the JAX CLI, plus --device
    where a detector is built."""
    ours, ref = _options(tcli.build_parser()), _options(_jax_parser(monkeypatch))
    assert set(ours) == set(ref) == set(SUBCOMMANDS)
    for name in SUBCOMMANDS:
        extra = {"--device"} if name in ("detect", "video", "evaluate", "serve", "profile") else set()
        assert ours[name] == ref[name] | extra, name
    args = tcli.build_parser().parse_args(["evaluate", "--model", "yolov3"])
    assert (args.device, args.batch) == ("cuda", tcli.EVAL_BATCH)


def _ns(files, *extra):
    """Parsed detect arguments both packages' _build_detector accept."""
    return tcli.build_parser().parse_args(
        ["detect", "--images", files["imgs"], "--cfg", files["cfg"], "--weights",
         files["weights"], "--reso", "160", "--device", "cpu", "--no-compile-cache", *extra])


def _state_close(ours: dict, ref: dict):
    assert sorted(ours["skip"]) == sorted(ref["skip"]) and ours["skip"]
    assert set(map(int, ours["scales"])) == set(map(int, ref["scales"])) and ours["scales"]
    ref_scales = {int(k): v for k, v in ref["scales"].items()}
    for k, v in ours["scales"].items():
        a, b = v, ref_scales[int(k)]
        if isinstance(a, dict):
            a, b = a["per_channel"], b["per_channel"]
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=0)


def test_int8_scales_load_in_both_packages(files, tmp_path):
    """A scales file the port calibrates ("auto", stamped) loads in the
    JAX CLI, and one the JAX CLI calibrates ("none") loads in the port:
    the same skip set, scales within 1e-6.  An "auto" file reloads under
    --int8-recipe auto (restart-safe) in both."""
    ours_path, jax_path = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    tdet = tcli._build_detector(_ns(files, "--int8", "--int8-calib", files["calib"],
                                    "--int8-scales", ours_path))
    with open(ours_path, encoding="utf-8") as f:
        written = json.load(f)
    assert written["recipe"] == "auto" and written["calib_size"] == [160, 160]
    jdet = jcli._build_detector(_ns(files, "--int8", "--int8-scales", ours_path))
    _state_close(json.loads(json.dumps(jdet.quant_state())), tdet.quant_state())
    for build in (tcli._build_detector, jcli._build_detector):
        again = build(_ns(files, "--int8", "--int8-recipe", "auto", "--int8-calib",
                          files["calib"], "--int8-scales", ours_path))
        _state_close(json.loads(json.dumps(again.quant_state())), written)

    jdet = jcli._build_detector(_ns(files, "--int8", "--int8-calib", files["calib"],
                                    "--int8-recipe", "none", "--int8-scales", jax_path))
    tdet = tcli._build_detector(_ns(files, "--int8", "--int8-scales", jax_path))
    _state_close(tdet.quant_state(), json.loads(json.dumps(jdet.quant_state())))


REFUSALS = {
    "calib without --int8": ["--int8-calib", "{calib}"],
    "scales without --int8": ["--int8-scales", "{existing}"],
    "skip-noisy without calib": ["--int8", "--int8-skip-noisy", "2"],
    "split-concat without calib": ["--int8", "--int8-split-concat"],
    "smooth without calib": ["--int8", "--int8-smooth"],
    "bias-correct without calib": ["--int8", "--int8-bias-correct"],
    "auto without calib": ["--int8", "--int8-recipe", "auto"],
    "weights-only with calib": ["--int8", "--int8-weights-only", "--int8-calib", "{calib}"],
    "missing scales, no calib": ["--int8", "--int8-scales", "{missing}"],
    "knob with existing scales": ["--int8", "--int8-calib", "{calib}", "--int8-scales",
                                  "{existing}", "--int8-bias-correct"],
    "auto with unstamped scales": ["--int8", "--int8-calib", "{calib}", "--int8-recipe",
                                   "auto", "--int8-scales", "{existing}"],
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_int8_flag_refusals_match_jax(files, tmp_path, case):
    existing = tmp_path / "old.json"
    existing.write_text(json.dumps({"version": 1, "scales": {}, "skip": []}))
    argv = [a.format(calib=files["calib"], existing=existing, missing=tmp_path / "none.json")
            for a in REFUSALS[case]]
    with pytest.raises(SystemExit) as ours:
        tcli._build_detector(_ns(files, *argv))
    with pytest.raises(SystemExit) as ref:
        jcli._build_detector(_ns(files, *argv))
    assert str(ours.value) == str(ref.value) and str(ours.value)


def test_device_and_devices_flags(files):
    """--device cuda exits where there is no card; --devices past the local
    count keeps JAX's message; --debug-nans raises at a non-finite layer;
    --no-compile-cache is accepted."""
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="is_available"):
            tcli._build_detector(_ns(files, "--device", "cuda"))
    with pytest.raises(SystemExit, match=r"--devices 2: only 1 local device\(s\) available"):
        tcli._build_detector(_ns(files, "--devices", "2"))
    det = tcli._build_detector(_ns(files, "--devices", "0", "--debug-nans"))
    img = np.zeros((64, 64, 3), np.uint8)
    assert det.detect(img, size=64) is not None
    with torch.no_grad():
        det.model.convs["2"].weight[0, 0, 0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="layer 2"):
        det.detect(img, size=64)


def test_serve_answers_a_post(files, monkeypatch):
    """serve in a thread: one POSTed PNG answered as detect_many u8 answers
    it, then a clean shutdown."""
    made, make = [], tserve.make_server

    def make_server(*args, **kwargs):
        made.append(make(*args, **kwargs))
        return made[-1]

    monkeypatch.setattr(tserve, "make_server", make_server)
    thread = threading.Thread(target=tcli.main, args=([
        "serve", "--cfg", files["cfg"], "--weights", files["weights"], "--reso", "160",
        "--port", "0", "--batch", "2", "--device", "cpu"],), daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 60
        while not made and time.monotonic() < deadline:
            time.sleep(0.05)
        host, port = made[0].server_address[:2]
        img = cv2.imread(os.path.join(files["imgs"], "im1.png"))
        req = urllib.request.Request(f"http://{host}:{port}/detect", data=encode_png(img),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
    finally:
        if made:
            made[0].shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
    ref = pt.Detector.load(files["cfg"], files["weights"], device="cpu").detect_many(
        [img], size=160, batch=1, transfer="u8")[0]
    assert answer["cls_id"] == ref.cls_id.tolist() and len(ref) > 0
    np.testing.assert_allclose(np.reshape(answer["boxes"], (-1, 4)), ref.boxes, rtol=0, atol=1e-4)


def test_video_matches_jax(files, tmp_path, monkeypatch):
    """video on an mp4 written with cv2: the same frame count and, frame by
    frame, the detections JAX's CLI draws."""
    src = str(tmp_path / "src.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (320, 240))
    rng = np.random.default_rng(1)
    for _ in range(12):
        w.write(rng.integers(0, 256, size=(240, 320, 3), dtype=np.uint8))
    w.release()
    drawn = {}
    for name, mod, extra in (("torch", tcli, ["--device", "cpu"]),
                             ("jax", jcli, ["--no-compile-cache"])):
        seen, draw = [], mod.draw_detections

        def record(image, boxes, cls_ids, scores, names, _seen=seen, _draw=draw):
            _seen.append((np.array(boxes), np.array(cls_ids), np.array(scores)))
            return _draw(image, boxes, cls_ids, scores, names)

        monkeypatch.setattr(mod, "draw_detections", record)
        out = str(tmp_path / f"{name}.mp4")
        assert mod.main(["video", "--source", src, "--out", out, "--cfg", files["cfg"],
                         "--weights", files["weights"], "--reso", "160", "--frames", "10",
                         *extra]) == 0
        cap = cv2.VideoCapture(out)
        n = 0
        while cap.read()[0]:
            n += 1
        cap.release()
        assert n == len(seen) == 10
        drawn[name] = seen
    assert sum(len(c) for _, c, _ in drawn["jax"]) >= 5
    for (b, c, s), (jb, jc, js) in zip(drawn["torch"], drawn["jax"]):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_allclose(b, jb, rtol=0, atol=1e-3)
        np.testing.assert_allclose(s, js, rtol=0, atol=1e-5)


def test_video_without_opencv_exits(files, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(SystemExit, match="OpenCV"):
        tcli.main(["video", "--source", "x.mp4", "--cfg", files["cfg"], "--device", "cpu"])


def test_profile_writes_rows_and_trace(files, tmp_path, capsys):
    """profile --pipeline and profile print the JSON rows; --profile DIR
    leaves a Chrome trace."""
    common = ["--cfg", files["cfg"], "--reso", "64", "--batch", "1", "--iters", "1",
              "--device", "cpu"]
    pipe = json.loads(run_cli(tcli.main, ["profile", "--pipeline", *common], capsys))
    assert [r["stage"] for r in pipe] == ["letterbox", "+forward", "+decode", "+nms"]
    trace = tmp_path / "trace"
    stages = json.loads(run_cli(tcli.main, ["profile", *common, "--profile", str(trace)], capsys))
    assert stages[-1]["stage"] == "head@23"
    with open(trace / "trace.json", encoding="utf-8") as f:
        assert json.load(f)["traceEvents"]


def test_module_runner_help():
    """python -m pytorch_yolo_tpu_torch --help lists every subcommand."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "pytorch_yolo_tpu_torch", "--help"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    for name in SUBCOMMANDS:
        assert name in proc.stdout

"""Command-line entry points: detection, video, evaluation, serving, profiling.

The port's copy of ``pytorch_yolo_tpu/cli.py`` on its own ``Detector``:

    python -m pytorch_yolo_tpu_torch detect --images dog.jpg --model yolov3 \\
        --weights yolov3.weights --reso 416 --det out/ --bf16
    python -m pytorch_yolo_tpu_torch video --source clip.mp4 --model yolov3-tiny
    python -m pytorch_yolo_tpu_torch info --model yolov3 --device cpu

Every subcommand and flag of the JAX command line, plus ``--device``
(``cuda`` by default: it raises where there is no card, and never carries
on on the CPU; ``--device cpu`` runs the kernels' plain versions).  Flag
names mirror the reference CLI (--confidence, --nms_thresh, --reso).
``--profile DIR`` writes a ``torch.profiler`` Chrome trace into DIR.
``--devices N`` splits every batch over the first N local cards (a batch
mesh, ``parallel/sharding.py``; 0 = every card) and rounds ``--batch`` up
to a multiple of N.

Images are read and written with OpenCV where ``cv2`` imports.  Without it
(the port's card machine has none) the command line reads PNG with the
standard-library decoder of ``serve.py`` and writes PNG with its encoder;
boxes are drawn without label text (``utils/draw.py``), and ``video``,
which needs ``cv2.VideoCapture``, exits with an error.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import sys
import time

import numpy as np
import torch

from .api import Detector
from .parallel.sharding import make_batch_mesh, pad_to_multiple
from .serve import decode_image, encode_png
from .utils.draw import draw_detections
from .utils.profiling import PipelineStats

log = logging.getLogger("pytorch_yolo_tpu_torch")

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")

# The evaluate --batch default: the best detect_many(transfer="u8") rate of
# batch 8, 16, 32 and 64 on the card (chip_smoke.py phase 16, help below).
EVAL_BATCH = 64


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--model", default=None,
                   help="zoo model name (yolov3, yolov3-tiny)")
    p.add_argument("--cfg", default=None, help="Darknet .cfg path")
    p.add_argument("--weights", default=None, help="Darknet .weights path")
    p.add_argument("--names", default=None, help=".names file (default COCO-80)")
    p.add_argument("--confidence", type=float, default=0.5)
    p.add_argument("--nms_thresh", type=float, default=0.4)
    p.add_argument("--reso", type=_parse_reso, default=416,
                   help="network input resolution: square (416) or "
                        "rectangular HxW (256x416, widescreen video); "
                        "reference trio 320/416/608; each dim must be a "
                        "multiple of the model's deepest stride — 64 for "
                        "yolov4-p6, 128 for yolov4-p7, 32 otherwise")
    p.add_argument("--max_det", type=int, default=300)
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; exits where there is no "
                        "card) or cpu (the kernels' plain versions)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute: every conv on the bf16 kernel K5 "
                        "(fp32 sums, fp32 bias and activation, one rounding); "
                        "not bit-faithful")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 convs on the int8 kernels K3/K4 (dynamic "
                        "activation scales unless --int8-calib is given). "
                        "Combine with --bf16 for int8 with bf16 glue; on an "
                        "H100 80GB HBM3 at 700.00 W that mode is still slower "
                        "than --bf16 alone (47.3 against 32.8 ms/batch, "
                        "yolov3@416 batch 128, chip_smoke.py phases 6 and 9)")
    p.add_argument("--int8-skip-heads", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="keep the detection-head output convs in fp under "
                        "--int8 (default on: quantizing them is the classic "
                        "mAP-killer)")
    p.add_argument("--int8-calib", default=None, metavar="DIR",
                   help="calibrate static activation scales from images in "
                        "DIR (up to 8): removes the per-conv dynamic "
                        "reductions")
    p.add_argument("--int8-calib-margin", type=float, default=1.0,
                   metavar="M",
                   help="multiply calibrated activation ranges by M (>1 "
                        "leaves headroom for activations beyond the "
                        "calibration set; out-of-range values saturate)")
    p.add_argument("--int8-calib-percentile", type=float, default=None,
                   metavar="Q",
                   help="calibrate from the Q-th percentile of |activation| "
                        "(e.g. 99.9) instead of the max — robust to outlier "
                        "activations in the calibration images")
    p.add_argument("--int8-skip-noisy", type=int, default=0, metavar="K",
                   help="with --int8-calib: rank every quantized conv's "
                        "isolated int8 noise on the calibration images and "
                        "keep the K noisiest in fp (the worst offenders are "
                        "typically the post-route-concat 1x1 convs)")
    p.add_argument("--int8-split-concat", action="store_true",
                   help="with --int8-calib: give each branch of a "
                        "route-concat conv input its own calibrated scale "
                        "(the conv splits along the reduction dim — same "
                        "FLOPs).  Targets bimodal concat magnitudes "
                        "defeating per-tensor scales")
    p.add_argument("--int8-smooth", type=float, default=None, nargs="?",
                   const=0.5, metavar="ALPHA",
                   help="with --int8-calib: SmoothQuant-style per-channel "
                        "smoothing — each conv input channel gets its own "
                        "quantization grid, folded into the int8 kernels "
                        "at calibration (zero runtime FLOPs; ALPHA in "
                        "[0,1] balances activation vs weight difficulty, "
                        "default 0.5).  Exclusive with --int8-split-concat")
    p.add_argument("--int8-bias-correct", action="store_true",
                   help="with --int8-calib: DFQ-style bias correction — "
                        "each quantized conv's mean pre-activation error "
                        "on the calibration images is absorbed into its "
                        "bias (zero runtime cost; deltas persist in the "
                        "scales file)")
    p.add_argument("--int8-weights-only", action="store_true",
                   help="with --int8: weight-only quantization (W8) — int8 "
                        "weights dequantized once, activations stay in the "
                        "compute dtype.  bf16-class accuracy (weight rounding "
                        "only); no calibration needed or accepted")
    p.add_argument("--int8-recipe", choices=("auto", "none"), default=None,
                   help="calibration recipe policy.  'auto' (the DEFAULT "
                        "whenever --int8-calib is given without explicit "
                        "knobs): p99.9 percentile ranging + per-channel "
                        "smoothing + bias correction, which drifts less "
                        "than 'none' on live yolov3 with bf16 glue on the "
                        "card (chip_smoke.py phase 11).  'none' opts out "
                        "(plain min/max-margin calibration).  Mutually "
                        "exclusive with the explicit knobs")
    p.add_argument("--int8-scales", default=None, metavar="JSON",
                   help="persisted static activation scales: if JSON exists "
                        "it is loaded (no calibration forward needed); "
                        "otherwise the scales calibrated via --int8-calib "
                        "are written there (calibrate once, serve many); "
                        "either package's file loads in the other")
    p.add_argument("--devices", type=int, default=1, metavar="N",
                   help="shard the batch over the first N local cards via a "
                        "batch mesh (one model replica a card, results "
                        "gathered on the first; parallel/sharding.py).  1 = "
                        "single device (default), 0 = every local device")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted and ignored: the JAX package's persistent "
                        "XLA compilation cache is not ported (the kernels are "
                        "built once into the package's csrc/_build/)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler Chrome trace to DIR")
    p.add_argument("--interp", default="linear", choices=("linear", "cubic"),
                   help="letterbox resize interpolation")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first layer whose "
                        "output is not finite (a host sync a layer)")
    p.add_argument("-v", "--verbose", action="store_true")


def _parse_reso(s: str):
    """416 -> 416; 256x416 -> (256, 416) (HxW, the API's tuple form)."""
    if "x" in s.lower():
        h, w = s.lower().split("x", 1)
        return (int(h), int(w))
    return int(s)


def _imread(path: str) -> "np.ndarray | None":
    """An image file as (H, W, 3) uint8 BGR, as ``cv2.imread`` gives it:
    OpenCV where it imports, else PNG by the standard library; None if the
    file does not decode."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    return decode_image(data) if data else None


def _imwrite(path: str, img: np.ndarray) -> None:
    """``cv2.imwrite`` where OpenCV imports, else PNG bytes by the standard
    library (whatever the extension)."""
    try:
        import cv2
    except ImportError:
        with open(path, "wb") as f:
            f.write(encode_png(img))
        return
    cv2.imwrite(path, img)


def _load_calib_images(directory: str, limit: int = 8) -> list:
    """Load up to ``limit`` images from a directory for int8 calibration."""
    paths = sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.lower().endswith(IMAGE_EXTS))[:limit]
    imgs = [im for im in (_imread(p) for p in paths) if im is not None]
    if not imgs:
        raise SystemExit(f"--int8-calib: no readable images in {directory}")
    return imgs


def _raise_on_nonfinite(index: int, x: torch.Tensor) -> None:
    """The --debug-nans layer hook."""
    if not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"--debug-nans: layer {index} output is not finite")


def _local_devices(device: torch.device) -> list[torch.device]:
    """The local devices ``--devices`` counts: every CUDA card for a CUDA
    ``--device``, else the one CPU."""
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _build_detector(args) -> Detector:
    source = args.cfg or args.model
    if source is None:
        raise SystemExit("one of --model / --cfg is required")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: torch.cuda.is_available() is False "
                         "(pass --device cpu to run on the CPU)")
    kw = {"interp": getattr(args, "interp", "linear")}
    n_dev = getattr(args, "devices", 1)
    if n_dev != 1:
        devs = _local_devices(device)
        if n_dev == 0:
            n_dev = len(devs)
        if not 1 <= n_dev <= len(devs):
            raise SystemExit(f"--devices {n_dev}: only {len(devs)} local "
                             f"device(s) available")
        if n_dev > 1:
            kw.update(mesh=make_batch_mesh(devs[:n_dev]))
            device = None  # the mesh's first entry
            log.info("sharding batches over %d devices", n_dev)
            batch = getattr(args, "batch", None)
            if batch is not None:
                # prepared pipelines (detect_many/evaluate/serve) stack
                # fixed-size chunks, which must divide the mesh: round the
                # bucket up rather than erroring later
                args.batch = pad_to_multiple(batch, n_dev)
                if args.batch != batch:
                    log.info("rounded --batch %d up to %d (multiple of %d "
                             "mesh devices)", batch, args.batch, n_dev)
    if args.bf16:
        kw.update(dtype=torch.bfloat16, precision="default")
    calib_dir = getattr(args, "int8_calib", None)
    if calib_dir and not getattr(args, "int8", False):
        raise SystemExit("--int8-calib requires --int8 (static scales "
                         "calibrate the int8 serving path)")
    scales_path = getattr(args, "int8_scales", None)
    if scales_path and not getattr(args, "int8", False):
        raise SystemExit("--int8-scales requires --int8")
    if getattr(args, "int8_skip_noisy", 0) and not calib_dir:
        raise SystemExit("--int8-skip-noisy requires --int8-calib DIR "
                         "(noise attribution runs on the calibration "
                         "images)")
    if getattr(args, "int8_split_concat", False) and not calib_dir:
        raise SystemExit("--int8-split-concat requires --int8-calib DIR "
                         "(per-branch scales come from the calibration "
                         "images)")
    if getattr(args, "int8_smooth", None) is not None and not calib_dir:
        raise SystemExit("--int8-smooth requires --int8-calib DIR "
                         "(per-channel grids come from the calibration "
                         "images)")
    if getattr(args, "int8_bias_correct", False) and not calib_dir:
        raise SystemExit("--int8-bias-correct requires --int8-calib DIR "
                         "(the correction averages quantization error on "
                         "the calibration images)")
    if getattr(args, "int8_recipe", None) == "auto" and not calib_dir:
        raise SystemExit("--int8-recipe auto requires --int8-calib DIR "
                         "(the recipe is a calibration policy; 'none' is "
                         "only meaningful with calibration too)")
    if getattr(args, "int8", False):
        weights_only = getattr(args, "int8_weights_only", False)
        if weights_only and (calib_dir or scales_path):
            raise SystemExit("--int8-weights-only has no activation "
                             "quantization — drop --int8-calib/--int8-"
                             "scales (w8a8 concepts)")
        kw.update(quant="w8" if weights_only else "w8a8",
                  quant_skip_layers=(
                      "heads" if getattr(args, "int8_skip_heads", True) else ()))
        if scales_path and os.path.exists(scales_path):
            with open(scales_path, "r", encoding="utf-8") as f:
                state = json.load(f)
            recipe = getattr(args, "int8_recipe", None)
            # "none" never needs a calibration run — any persisted scales
            # load as-is; "auto" only reloads a file stamped by the same
            # recipe (a calibrated file IS the recipe's output).
            if recipe == "auto" and isinstance(state, dict) \
                    and state.get("recipe") == recipe:
                pass  # restart-safe: the file IS this recipe's output
            elif getattr(args, "int8_skip_noisy", 0) or \
                    getattr(args, "int8_split_concat", False) or \
                    getattr(args, "int8_smooth", None) is not None or \
                    getattr(args, "int8_bias_correct", False) or \
                    recipe == "auto":
                raise SystemExit(
                    "--int8-skip-noisy/--int8-split-concat/--int8-smooth/"
                    f"--int8-bias-correct/--int8-recipe need a calibration "
                    f"run; {scales_path} already exists and its persisted "
                    "state applies — delete it to re-calibrate (a file "
                    "stamped by --int8-recipe reloads under the same "
                    "recipe flag)")
            if isinstance(state, dict) and state.get("calib_size"):
                served = args.reso if isinstance(args.reso, tuple) \
                    else (args.reso, args.reso)
                if tuple(state["calib_size"]) != served:
                    log.warning(
                        "--int8-scales %s was calibrated at %s but serving "
                        "at %s: static scales are only valid at the "
                        "calibrated size (activation maxima scale with the "
                        "spatial extent) — delete the file to re-calibrate "
                        "at --reso", scales_path, state["calib_size"], list(served))
            if isinstance(state, dict) and "scales" in state:
                # quant_state() format: scales + the resolved skip set of
                # the calibration run (reproduces the exact quantized-conv
                # partition, incl. --int8-skip-noisy picks).
                kw.update(quant_act_scales=state["scales"],
                          quant_skip_layers=frozenset(
                              int(i) for i in state.get("skip", ())))
                if state.get("bias_delta"):
                    kw.update(quant_bias_delta=state["bias_delta"])
            else:  # legacy flat {idx: scale}: default skip policy
                kw.update(quant_act_scales=state)
            log.info("loaded static int8 scales from %s (no calibration "
                     "forward)", scales_path)
        elif calib_dir:
            # images are read BGR (as cv2.imread) and the detector defaults
            # to bgr=True, so calibration runs on the served channel order;
            # it runs at the SERVED resolution, not the cfg's [net] size
            # (activation maxima scale with the spatial extent)
            kw.update(quant_calib=_load_calib_images(calib_dir),
                      quant_calib_size=args.reso,
                      quant_calib_margin=getattr(args, "int8_calib_margin", 1.0),
                      quant_calib_percentile=getattr(
                          args, "int8_calib_percentile", None),
                      quant_skip_noisy=getattr(args, "int8_skip_noisy", 0),
                      quant_split_concat=getattr(
                          args, "int8_split_concat", False),
                      quant_smooth=getattr(args, "int8_smooth", None),
                      quant_bias_correct=getattr(
                          args, "int8_bias_correct", False),
                      quant_recipe=getattr(args, "int8_recipe", None))
        elif scales_path:
            raise SystemExit(f"--int8-scales {scales_path}: file does not "
                             "exist and no --int8-calib DIR given to "
                             "calibrate it")
    weights = args.weights
    if weights is None and not source.endswith(".cfg"):
        # adopt provided assets the moment they appear (reuse a report an
        # earlier step already scanned, e.g. cmd_evaluate's)
        report = getattr(args, "_asset_report", None)
        if report is None:
            from .assets import scan_assets

            report = scan_assets()
        want = f"{source}.weights"
        hit = next((w for w in report.weights
                    if w.expected_name == want and w.header_ok), None)
        if hit is not None:
            weights = hit.path
            log.info("using discovered weights asset: %s", weights)
    det = Detector.load(source, weights, names=args.names, device=device, **kw)
    det.weights_source = weights  # provenance: None = synthetic random
    if getattr(args, "debug_nans", False):
        for replica in det._replicas:
            replica.layer_hook = _raise_on_nonfinite
    if scales_path and not os.path.exists(scales_path):
        state = det.quant_state()
        with open(scales_path, "w", encoding="utf-8") as f:
            json.dump(state, f)
        log.info("wrote %d calibrated int8 scales (+%d-conv skip set) to %s",
                 len(state["scales"]), len(state["skip"]), scales_path)
    if weights is None:
        log.warning("no --weights given and no asset found: using synthetic "
                    "random weights (run `python -m pytorch_yolo_tpu_torch "
                    "assets` for the expected drop points)")
    return det


@contextlib.contextmanager
def _maybe_profile(trace_dir, device: str):
    """A ``torch.profiler`` run around the command, its Chrome trace written
    to ``trace_dir/trace.json`` (the card's kernels too on a CUDA device)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def cmd_detect(args) -> int:
    det = _build_detector(args)
    if os.path.isdir(args.images):
        paths = sorted(
            os.path.join(args.images, f) for f in os.listdir(args.images)
            if f.lower().endswith(IMAGE_EXTS))
    else:
        paths = [args.images]
    if not paths:
        raise SystemExit(f"no images found in {args.images}")
    os.makedirs(args.det, exist_ok=True)

    stats = PipelineStats()
    stats.start()

    # Group images by source shape so each group runs as true batches under
    # one pipeline.
    groups: dict[tuple, list[tuple[str, "np.ndarray"]]] = {}
    for path in paths:
        with stats.stage("read"):
            img = _imread(path)
        if img is None:
            log.warning("cannot read %s, skipping", path)
            continue
        groups.setdefault(img.shape, []).append((path, img))

    json_out = open(os.path.join(args.det, "detections.jsonl"), "w",
                    encoding="utf-8") if args.save_json else None
    try:
        for shape, items in groups.items():
            for start in range(0, len(items), args.batch):
                chunk = items[start : start + args.batch]
                batch = np.stack([im for _, im in chunk])
                with stats.stage("detect"):
                    dets = det.detect_batch(batch, size=args.reso, conf=args.confidence,
                                            iou=args.nms_thresh, max_det=args.max_det)
                with stats.stage("draw+write"):
                    for (path, img), d in zip(chunk, dets):
                        names = [det.class_names[c] for c in d.cls_id]
                        if json_out is not None:
                            json_out.write(json.dumps({
                                "image": path,
                                "boxes": d.boxes.round(2).tolist(),
                                "obj": d.obj.round(4).tolist(),
                                "cls_score": d.cls_score.round(4).tolist(),
                                "cls_id": d.cls_id.tolist(),
                                "names": names,
                            }) + "\n")
                        draw_detections(img, d.boxes, d.cls_id, d.obj, det.class_names)
                        out_path = os.path.join(args.det, "det_" + os.path.basename(path))
                        _imwrite(out_path, img)
                        log.info("%s: %d objects %s -> %s", path, len(d),
                                 sorted(set(names)), out_path)
                stats.count(len(chunk))
    finally:
        if json_out is not None:
            json_out.close()
    print(stats.report(), file=sys.stderr)
    return 0


def cmd_video(args) -> int:
    try:
        import cv2
    except ImportError:
        raise SystemExit("video needs OpenCV (cv2.VideoCapture), which this "
                         "host does not have") from None

    from .video import run_video

    det = _build_detector(args)
    source = int(args.source) if args.source.isdigit() else args.source
    writer = None
    stats = PipelineStats()
    shown = 0
    t0 = time.perf_counter()
    for fr in run_video(source, det, size=args.reso, conf=args.confidence,
                        iou=args.nms_thresh, max_det=args.max_det,
                        stats=stats, max_frames=args.frames):
        d = fr.detection
        draw_detections(fr.frame, d.boxes, d.cls_id, d.obj, det.class_names)
        if args.out:
            if writer is None:
                h, w = fr.frame.shape[:2]
                writer = cv2.VideoWriter(
                    args.out, cv2.VideoWriter_fourcc(*"mp4v"),
                    args.fps, (w, h))
            writer.write(fr.frame)
        if args.show:
            cv2.imshow("pytorch_yolo_tpu_torch", fr.frame)
            if cv2.waitKey(1) & 0xFF == ord("q"):
                break
        shown += 1
        if shown % 50 == 0:
            fps = shown / (time.perf_counter() - t0)
            log.info("frame %d  FPS %.1f", fr.index, fps)
    if writer is not None:
        writer.release()
    print(stats.report(), file=sys.stderr)
    return 0


def cmd_evaluate(args) -> int:
    """COCO mAP evaluation."""
    from .datasets import load_coco
    from .eval import ImageEval, evaluate, evaluate_coco

    if args.images is None or args.annotations is None:
        from .assets import report_text, scan_assets

        report = scan_assets()
        args._asset_report = report  # let _build_detector reuse the scan
        pair = report.matched_eval_pair()  # matched, not independent [0]s
        if pair is not None:
            if args.annotations is None:
                args.annotations = pair[0]
                log.info("using discovered annotations: %s", args.annotations)
            if args.images is None:
                args.images = pair[1]
                log.info("using discovered image dir: %s", args.images)
        if args.images is None or args.annotations is None:
            print(report_text(report), file=sys.stderr)
            raise SystemExit("evaluate needs --images/--annotations (no asset found)")

    det = _build_detector(args)
    evals = []
    stats = PipelineStats()
    stats.start()
    skipped: list[str] = []
    kept_samples: list = []

    def image_gen():
        for sample in load_coco(args.annotations, args.images,
                                max_images=args.max_images):
            img = _imread(sample.path)
            if img is None:
                skipped.append(sample.path)
                continue
            kept_samples.append(sample)
            yield img

    # u8-canvas batches through detect_many: COCO's mixed sizes share one
    # prepared pipeline, a quarter of the bytes cross the link, and the host
    # letterbox of one chunk overlaps the device work of the last.
    def _batched():
        # super-chunks of 8 device batches: detect_many double-buffers
        # within a call, so the pipeline bubble at each boundary amortizes
        span = args.batch * 8
        chunk: list = []
        for img in image_gen():
            chunk.append(img)
            if len(chunk) == span:
                yield from det.detect_many(
                    chunk, size=args.reso, conf=args.confidence,
                    iou=args.nms_thresh, max_det=args.max_det,
                    batch=args.batch, transfer="u8")
                chunk = []
        if chunk:
            yield from det.detect_many(
                chunk, size=args.reso, conf=args.confidence,
                iou=args.nms_thresh, max_det=args.max_det,
                batch=args.batch, transfer="u8")

    # the steady rate leaves out the first super-chunk, which pays the
    # one-time costs (the kernel library's load, first-launch set-up)
    t_steady, n_steady = None, 0
    for i, d in enumerate(_batched()):
        sample = kept_samples[i]
        score = d.obj * d.cls_score if args.score == "obj*cls" else d.obj
        evals.append(ImageEval(
            det_boxes=d.boxes, det_scores=score, det_classes=d.cls_id,
            gt_boxes=sample.gt_boxes, gt_classes=sample.gt_classes,
            gt_crowd=sample.gt_crowd))
        stats.count()
        if i + 1 == args.batch * 8:  # first super-chunk done
            t_steady, n_steady = time.perf_counter(), i + 1
    steady = ((len(evals) - n_steady) / (time.perf_counter() - t_steady)
              if t_steady is not None and len(evals) > n_steady else None)
    if skipped:
        log.warning("skipped %d unreadable images", len(skipped))
    if getattr(args, "save_dets", None):
        # one triplet of arrays per image, keyed by index: two evaluate runs
        # compare at detection level, not just by mAP
        dump = {}
        for i, e in enumerate(evals):
            dump[f"boxes_{i}"] = np.asarray(e.det_boxes)
            dump[f"scores_{i}"] = np.asarray(e.det_scores)
            dump[f"classes_{i}"] = np.asarray(e.det_classes)
        np.savez_compressed(args.save_dets, n_images=len(evals), **dump)
        log.info("wrote %d images' detections to %s", len(evals),
                 args.save_dets)
    r50 = evaluate(evals, iou_thresh=0.5)
    coco = evaluate_coco(evals)
    print(json.dumps({
        "images": len(evals),
        "mAP@0.5": round(r50["mAP"], 4),
        "AP@[.5:.95]": round(coco["AP"], 4),
        "AP75": round(coco["AP75"], 4),
        "images_per_sec": round(stats.throughput(), 2),
        "images_per_sec_steady": (round(steady, 2) if steady is not None
                                  else None),
        # machine-readable provenance: a synthetic-weights run must never be
        # mistaken for a real parity number
        "weights": det.weights_source or "SYNTHETIC-RANDOM",
    }))
    print(stats.report(), file=sys.stderr)
    return 0


def cmd_info(args) -> int:
    """Print a model summary (layers, params, heads, detection counts)."""
    from .config import ConvSpec, head_strides, load_model_spec
    from .models.zoo import TOPOLOGY_PINS
    from .models.zoo import model_spec as zoo_spec
    from .weights import param_count

    source = args.cfg or args.model
    if source is None:
        raise SystemExit("one of --model / --cfg is required")
    spec = load_model_spec(source) if source.endswith(".cfg") else zoo_spec(source)
    convs = [l for l in spec.layers if isinstance(l, ConvSpec)]
    heads = spec.yolo_layers

    print(f"model: {source}")
    print(f"layers: {len(spec.layers)}  convs: {len(convs)}  "
          f"params: {param_count(spec):,} ({param_count(spec) * 4 / 1e6:.1f} MB fp32)")
    if not source.endswith(".cfg"):
        status, note = TOPOLOGY_PINS.get(source, (None, None))
        if status is not None:
            print(f"topology: {status} — {note}")
    print(f"net input: {spec.net.width}x{spec.net.height}  classes: {spec.num_classes}")
    for h, s in zip(heads, head_strides(spec)):
        print(f"  head @stride {s:>2}: anchors {h.anchors}")
    mod = max(32, max(head_strides(spec)))
    ladder = (320, 416, 608) if mod == 32 else (640, 896, 1280)
    for size in ladder:
        print(f"  detections @{size}: {spec.num_detections(size)}")
    if getattr(args, "int8_plan", False):
        _print_int8_plan(spec, convs)
    return 0


def _print_int8_plan(spec, convs) -> None:
    """The static-int8 (--int8 --bf16) policy this model gets by default:
    which convs stay fp and why, how many int8-resident links engage, and
    which convs are split-concat candidates.  Pure topology — no params
    are loaded (int8_resident_chains only membership-tests the params, so
    a marker dict stands in for quantized params).  Honors
    PYTORCH_YOLO_INT8_EARLY_STRIDE the same way Detector construction
    does, so the printout matches a forced-threshold deployment."""
    from .ops.quant import (concat_split_groups, default_early_min_stride,
                            early_conv_indices, early_skip_profitable,
                            head_conv_indices, int8_resident_chains)

    heads = head_conv_indices(spec)
    profitable = early_skip_profitable(spec)
    env = os.environ.get("PYTORCH_YOLO_INT8_EARLY_STRIDE")
    min_stride = int(env) if env is not None else default_early_min_stride(spec)
    early = (early_conv_indices(spec, min_stride) if min_stride > 1
             else frozenset())
    skip = heads | early
    quantized = [l.index for l in convs if l.index not in skip]
    marker = {i: {"wq": None, "sa": None} for i in quantized}
    chains = int8_resident_chains(spec, marker)
    splits = concat_split_groups(spec)
    print("int8 plan (defaults for --int8 --bf16):")
    if profitable:
        reason = f"no early maxpool ladder -> default stride<{min_stride} skip"
        if min_stride == 32:
            reason += " (stride-128-deep ladder: large-spatial stages lose int8)"
    else:
        reason = "early maxpool ladder -> int8-resident chains instead"
    src = f"env stride<{min_stride}" if env is not None else reason
    print(f"  early-skip profitable: {profitable} ({src})")
    print(f"  convs quantized: {len(quantized)}/{len(convs)}  "
          f"(fp: {len(heads)} head + {len(early)} early)")
    print(f"  int8-resident chain links: {len(chains)} "
          "(engage only with --int8-calib static scales; "
          "dynamic int8 has no resident links)")
    print(f"  split-concat candidates (--int8-split-concat): "
          f"{sorted(splits)}")


def cmd_serve(args) -> int:
    """HTTP detection server with micro-batching (serve.py)."""
    from .serve import bucket_ladder, make_server

    det = _build_detector(args)
    server = make_server(det, host=args.host, port=args.port, size=args.reso,
                         conf=args.confidence, iou=args.nms_thresh,
                         max_det=args.max_det, batch_max=args.batch,
                         batch_timeout_ms=args.batch_timeout_ms)
    # run once every batch bucket the MicroBatcher can dispatch (its own
    # batch_max, so warmup cannot desync from the flush arithmetic): no
    # first client request waits on the kernel library or a first launch
    ladder = bucket_ladder(server.batcher.batch_max, server.batcher.bucket_floor)
    rh, rw = (args.reso, args.reso) if isinstance(args.reso, int) else args.reso
    for b in ladder:
        x = np.zeros((b, rh, rw, 3), np.uint8)
        g = np.tile([[1.0, 0, 0, 1, 1]], (b, 1)).astype(np.float32)
        det.detect_prepared(x, g, args.reso, conf=args.confidence,
                            iou=args.nms_thresh, max_det=args.max_det)
    log.info("prepared pipelines warmed for batch buckets %s", ladder)
    host, port = server.server_address[:2]
    log.info("serving on http://%s:%s  (POST /detect, GET /healthz /stats)",
             host, port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.close()
        server.server_close()
    return 0


def cmd_profile(args) -> int:
    """Per-stage forward cost, one eager run marked at each cut."""
    from .utils.profiling import profile_pipeline, profile_stages

    det = _build_detector(args)
    if det.mesh.size > 1:
        print(f"profile on a mesh of {det.mesh.size}: the first replica ({det.device}) with "
              f"the whole batch of {args.batch}, as the JAX profiler times replicated params "
              "on an unsharded input", file=sys.stderr)
    if args.pipeline:
        rows = profile_pipeline(det, size=args.reso, batch=args.batch,
                                iters=args.iters)
        print(json.dumps(rows))
        for r in rows:
            print(f"  {r['stage']:<10}  cum {r['cum_ms']:8.2f} ms  "
                  f"delta {r['delta_ms']:8.2f} ms  {r['img_per_s']:8.1f} img/s",
                  file=sys.stderr)
        return 0
    rows = profile_stages(det, size=args.reso, batch=args.batch,
                          iters=args.iters)
    print(json.dumps(rows))
    width = max(len(r["stage"]) for r in rows)
    for r in rows:
        print(f"  layer {r['layer']:>3}  {r['stage']:<{width}}  "
              f"cum {r['cum_ms']:8.2f} ms  delta {r['delta_ms']:8.2f} ms",
              file=sys.stderr)
    return 0


def cmd_assets(args) -> int:
    """Scan for weights/COCO assets; rc 0 when everything the mAP-parity run
    needs is present, 1 otherwise."""
    from .assets import report_text, scan_assets

    report = scan_assets(extra_dirs=args.dirs or None)
    print(report_text(report))
    return 0 if report.ready else 1


def cmd_export_cfg(args) -> int:
    from .models.zoo import write_cfg

    write_cfg(args.model, args.out, classes=args.classes)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pytorch_yolo_tpu_torch",
                                 description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("detect", help="detect objects in image(s)")
    _add_common(p)
    p.add_argument("--images", required=True, help="image file or directory")
    p.add_argument("--det", default="det", help="output directory")
    p.add_argument("--batch", type=int, default=8,
                   help="max images per device batch (grouped by shape)")
    p.add_argument("--save-json", action="store_true",
                   help="also write <det>/detections.jsonl")
    p.set_defaults(fn=cmd_detect)

    p = sub.add_parser("video", help="video file / webcam detection (needs OpenCV)")
    _add_common(p)
    p.add_argument("--source", required=True, help="video path or webcam index")
    p.add_argument("--out", default=None, help="output video path (mp4)")
    p.add_argument("--show", action="store_true", help="cv2.imshow preview")
    p.add_argument("--fps", type=float, default=30.0, help="output video fps")
    p.add_argument("--frames", type=int, default=None, help="stop after N frames")
    p.set_defaults(fn=cmd_video)

    p = sub.add_parser("evaluate", help="COCO mAP evaluation")
    _add_common(p)
    p.add_argument("--images", default=None,
                   help="COCO images directory (default: discovered asset)")
    p.add_argument("--annotations", default=None,
                   help="instances_*.json path (default: discovered asset)")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--score", default="obj", choices=("obj", "obj*cls"),
                   help="detection score used for PR ranking")
    p.add_argument("--batch", type=int, default=EVAL_BATCH,
                   help="device batch of the chunked u8-canvas evaluate path; "
                        "64 read the most of 8/16/32/64 on an H100 80GB HBM3 "
                        "at 700.00 W (fp32 yolov3@416, 480x640 frames: 200.6 "
                        "img/s against 143.6/150.3/172.2, medians of 3 "
                        "windows, chip_smoke.py phase 16)")
    p.add_argument("--save-dets", default=None, metavar="NPZ",
                   help="also dump per-image detections (boxes/scores/"
                        "classes) to an .npz — lets two evaluate runs be "
                        "compared at detection level, not just by mAP "
                        "(which is vacuously 0.0==0.0 on synthetic weights)")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser("info", help="print a model summary")
    p.add_argument("--model", default=None)
    p.add_argument("--cfg", default=None)
    p.add_argument("--int8-plan", action="store_true",
                   help="also print the static-int8 serving plan this model "
                        "gets under the defaults (--int8 --bf16): skip set, "
                        "int8-resident chain links, split-concat candidates")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("serve", help="HTTP detection server (micro-batched)")
    _add_common(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch", type=int, default=8,
                   help="max images coalesced into one device batch")
    p.add_argument("--batch-timeout-ms", type=float, default=5.0,
                   help="max wait to fill a batch before dispatching")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("profile", help="per-stage forward cost profile")
    _add_common(p)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--pipeline", action="store_true",
                   help="profile e2e pipeline stages (letterbox/forward/"
                        "decode/nms) instead of forward layers")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("assets", help="scan for weights/COCO assets and print "
                                      "the parity command")
    p.add_argument("dirs", nargs="*", help="extra directories to scan")
    p.set_defaults(fn=cmd_assets)

    p = sub.add_parser("export-cfg", help="emit a zoo model as a Darknet .cfg")
    p.add_argument("--model", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--classes", type=int, default=80)
    p.set_defaults(fn=cmd_export_cfg)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if getattr(args, "verbose", False) else logging.INFO,
        format="%(levelname)s %(name)s: %(message)s")
    with _maybe_profile(getattr(args, "profile", None), getattr(args, "device", "cpu")):
        return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

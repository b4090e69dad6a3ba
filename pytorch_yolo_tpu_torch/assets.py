"""Asset discovery: pretrained weights + COCO data.

A copy of ``pytorch_yolo_tpu/assets.py``.  The mAP-parity run needs files
the repository does not ship (pretrained ``.weights``, COCO val images and
annotations).  This module scans for them and prints the exact evaluation
command to run the moment they appear.

Expected assets (sizes are the public Darknet releases):

===================  ============  =======================================
file                 approx size   what it is
===================  ============  =======================================
yolov3.weights       248 007 048   full YOLOv3-416 COCO weights
yolov3-tiny.weights   35 434 956   tiny-YOLOv3 COCO weights
yolov3-spp.weights   252 732 052   YOLOv3-SPP COCO weights
yolov2.weights       203 934 260   YOLOv2-608 COCO weights
yolov4.weights       257 717 640   YOLOv4-416 COCO weights (CSP+SPP+PAN)
yolov4-tiny.weights   24 251 276   tiny-YOLOv4 COCO weights
yolov4-csp.weights   211 944 840   Scaled-YOLOv4 CSP (size from our spec)
yolov4x-mish.weights 388 143 080   Scaled-YOLOv4 CSP-X (size from our spec)
yolov4-p5.weights    283 669 892   Scaled-YOLOv4 P5 (size from our spec)
yolov4-p6.weights    514 118 356   Scaled-YOLOv4 P6 (size from our spec)
yolov4-p7.weights  1 354 504 836   Scaled-YOLOv4 P7 (size from our spec)
instances_val2017.json     ~19 MB  COCO 2017 val annotations
val2017/                  5k jpgs  COCO 2017 val images
===================  ============  =======================================

Search order: ``$PYTORCH_YOLO_ASSETS`` (colon-separated), then the
checkout's ``assets/`` directory, then any directories the caller passes.
Where the JAX package also scans four fixed drop points outside the
checkout, the port looks only where it is told.  Weight files are
validated by their Darknet header (version ints), not just the name.
The printed command runs the port's own command line.
"""

from __future__ import annotations

import dataclasses
import os
import struct

# Public Darknet release sizes in bytes (exact); matching is name-first with
# a +-2% size sanity band, so re-exported files still match.
EXPECTED_WEIGHTS = {
    "yolov3.weights": 248_007_048,
    "yolov3-tiny.weights": 35_434_956,
    "yolov3-spp.weights": 252_732_052,
    "yolov2.weights": 203_934_260,
    "yolov2-tiny.weights": 44_948_600,
    # v4 sizes computed from the zoo specs (20-byte v0.2 header + 4 bytes per
    # param); yolov4 matches the public release byte count exactly, which
    # independently confirms the generator reproduces the upstream topology.
    "yolov4.weights": 257_717_640,
    "yolov4-tiny.weights": 24_251_276,
    # Scaled-YOLOv4 dialect models: sizes computed from OUR generated specs.
    # Their upstream layer indices are unverified, so a real release file
    # may land outside the band — the scanner still reports it by name with
    # header info for manual adoption.
    "yolov4-csp.weights": 211_944_840,
    "yolov4x-mish.weights": 388_143_080,
    "yolov4-p5.weights": 283_669_892,
    "yolov4-p6.weights": 514_118_356,
    "yolov4-p7.weights": 1_354_504_836,
}

ANNOTATION_NAMES = ("instances_val2017.json", "instances_val2014.json")

SEARCH_DIRS = (
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "assets"),
)


@dataclasses.dataclass
class FoundWeights:
    path: str
    size: int
    expected_name: str | None   # EXPECTED_WEIGHTS key if name+size match
    header_ok: bool             # Darknet version header sanity


@dataclasses.dataclass
class AssetReport:
    weights: list[FoundWeights]
    annotations: list[str]       # COCO instances json paths
    image_dirs: list[str]        # directories that look like COCO val images

    @property
    def ready(self) -> bool:
        return bool(self.weights and self.annotations and self.image_dirs)

    def matched_eval_pair(self) -> "tuple[str, str] | None":
        """(annotations, image_dir) that actually belong together.

        Prefers an image dir whose basename matches the annotation's split
        (instances_val2017.json -> .../val2017), else one sharing a parent
        directory — picking [0] of each independently can pair val2014
        annotations with val2017 images."""
        for ann in self.annotations:
            split = (os.path.basename(ann)
                     .removeprefix("instances_").removesuffix(".json"))
            for d in self.image_dirs:
                if os.path.basename(os.path.normpath(d)) == split:
                    return ann, d
        for ann in self.annotations:
            ann_root = os.path.dirname(os.path.abspath(ann))
            for d in self.image_dirs:
                if os.path.abspath(d).startswith(ann_root):
                    return ann, d
        if self.annotations and self.image_dirs:
            return self.annotations[0], self.image_dirs[0]
        return None


def _search_dirs() -> list[str]:
    env = os.environ.get("PYTORCH_YOLO_ASSETS", "")
    dirs = [d for d in env.split(os.pathsep) if d]
    dirs += list(SEARCH_DIRS)
    return [d for d in dirs if os.path.isdir(d)]


def check_weights_header(path: str) -> bool:
    """True if the file starts with a plausible Darknet header
    (major/minor/revision int32s)."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
        if len(head) < 12:
            return False
        major, minor, revision = struct.unpack("<3i", head)
    except OSError:
        return False
    return 0 <= major <= 10 and 0 <= minor <= 100 and 0 <= revision <= 10_000


def _classify_weights(path: str) -> FoundWeights:
    size = os.path.getsize(path)
    name = os.path.basename(path)
    expected = None
    exp = EXPECTED_WEIGHTS.get(name)
    if exp is not None and abs(size - exp) <= 0.02 * exp:
        expected = name
    return FoundWeights(path=path, size=size, expected_name=expected,
                        header_ok=check_weights_header(path))


def _looks_like_image_dir(d: str) -> bool:
    try:
        names = os.listdir(d)
    except OSError:
        return False
    imgs = [n for n in names[:200] if n.lower().endswith((".jpg", ".jpeg", ".png"))]
    return len(imgs) >= 5


def scan_assets(extra_dirs: list[str] | None = None) -> AssetReport:
    """Scan the documented locations for weights + COCO annotations/images.

    One os.walk per search directory collects every pattern at once (a COCO
    val tree holds 5k files; repeated recursive globs are needless churn)."""
    dirs = list(extra_dirs or []) + _search_dirs()
    weights: list[FoundWeights] = []
    annotations: list[str] = []
    image_dirs: list[str] = []
    seen: set[str] = set()
    image_dir_names = ("val2017", "val2014", "images")
    for d in dirs:
        d = os.path.abspath(d)
        if d in seen:
            continue
        seen.add(d)
        for root, subdirs, files in os.walk(d):
            for f in sorted(files):
                if f.endswith(".weights"):
                    weights.append(_classify_weights(os.path.join(root, f)))
                elif f in ANNOTATION_NAMES:
                    annotations.append(os.path.join(root, f))
            for s in sorted(subdirs):
                if s in image_dir_names:
                    p = os.path.join(root, s)
                    if _looks_like_image_dir(p):
                        image_dirs.append(p)
        if _looks_like_image_dir(d):
            image_dirs.append(d)
    return AssetReport(weights=weights, annotations=annotations,
                       image_dirs=image_dirs)


def report_text(report: AssetReport) -> str:
    """Human-readable asset report + the exact parity command when ready."""
    lines = ["asset scan (set PYTORCH_YOLO_ASSETS or drop files in "
             + ", ".join(SEARCH_DIRS) + "):"]
    if report.weights:
        for w in report.weights:
            tag = w.expected_name or "unrecognized"
            hdr = "header ok" if w.header_ok else "BAD HEADER"
            lines.append(f"  weights: {w.path} ({w.size:,} B, {tag}, {hdr})")
    else:
        lines.append("  weights: NONE (expected e.g. yolov3.weights, "
                     f"{EXPECTED_WEIGHTS['yolov3.weights']:,} B)")
    lines.append("  annotations: " + (", ".join(report.annotations) or
                                      "NONE (expected instances_val2017.json)"))
    lines.append("  image dirs: " + (", ".join(report.image_dirs) or
                                     "NONE (expected val2017/ with jpgs)"))
    if report.ready:
        w = next((x for x in report.weights if x.expected_name == "yolov3.weights"),
                 report.weights[0])
        model = (w.expected_name or "yolov3.weights").removesuffix(".weights")
        lines.append("")
        lines.append("READY — run mAP parity now:")
        lines.append(
            f"  python -m pytorch_yolo_tpu_torch evaluate --model {model} "
            f"--weights {w.path} --annotations {report.annotations[0]} "
            f"--images {report.image_dirs[0]} --reso 416 --confidence 0.005 "
            f"--nms_thresh 0.45 --score obj*cls")
    else:
        lines.append("  -> mAP parity remains blocked on the missing items above")
    return "\n".join(lines)

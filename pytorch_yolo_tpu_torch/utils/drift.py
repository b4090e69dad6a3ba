"""Box-drift measurement between two serving configurations.

Answers "is the fast mode safe to serve?" with data (VERDICT r1 weak #3/#4):
given two Detectors (e.g. fp32/HIGHEST vs bf16, or fp32 vs W8A8 int8), run
both on the same images and quantify how far the kept detection sets and box
coordinates diverge *after* NMS — the quantity that actually moves mAP.

Metrics per image pair, aggregated over the set:

* ``set_agreement`` — |matched pairs| / max(|A|, |B|) where a pair is a
  reference box and its nearest candidate box within ``match_px``.
* ``box_p99_px`` — 99th percentile of the max-coordinate deviation among
  matched pairs (pixels, original image coordinates).
* ``score_p99`` — 99th percentile of |score_a − score_b| among matched pairs.

A copy of ``pytorch_yolo_tpu/utils/drift.py`` (that package imports jax on
import); ``tests/test_torch_slice.py`` holds the two equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DriftStats:
    images: int
    ref_dets: int
    alt_dets: int
    set_agreement: float      # fraction of dets matched across modes
    box_mean_px: float
    box_p99_px: float
    score_p99: float
    # Channel-liveness diagnostics (VERDICT r4 weak #2): saturated-weight
    # regimes pin every ref score to exactly 1.0 and border-clamp every
    # box, so box_p99_px/score_p99 read 0.0 as an *artifact*, not a bound.
    ref_sat_frac: float = 0.0   # fraction of ref scores >= 0.9999
    zero_dev_frac: float = 0.0  # fraction of matched pairs with dev == 0 px
    # p95-p5 spread of the ref score distribution: a near-constant score
    # field (spp's live regime measured 0.016 — 22 dets all at 0.846-0.862)
    # makes the NMS ranking an effective tie, so tiny numeric noise
    # reshuffles keep-sets and set_agreement collapses without any real
    # accuracy signal (r5 diagnosis, PERF.md six-family table caveat).
    ref_score_spread: float = 1.0

    @property
    def degenerate(self) -> bool:
        """True when the regime cannot produce a meaningful measurement:
        most reference scores sit at sigmoid saturation, essentially every
        matched pair deviates by exactly 0.0 px, or the ref scores are so
        tightly clustered that the ranking is an effective tie.  A
        degenerate measurement's box_p99_px/score_p99 are meaningless and
        its set_agreement is measured on a degenerate ranking —
        re-generate weights (e.g. ``weights.equalize_raw_params``) instead
        of banking the row."""
        return (self.ref_sat_frac > 0.5
                or (self.zero_dev_frac > 0.99 and self.ref_dets > 0)
                or (self.ref_score_spread < 0.02 and self.ref_dets > 0))

    def row(self) -> str:
        tail = "  [DEGENERATE REGIME — do not bank]" if self.degenerate else ""
        return (f"agree={self.set_agreement:.3f} box_mean={self.box_mean_px:.3f}px "
                f"box_p99={self.box_p99_px:.3f}px score_p99={self.score_p99:.4f} "
                f"({self.ref_dets}/{self.alt_dets} dets on {self.images} imgs, "
                f"sat={self.ref_sat_frac:.2f} zerodev={self.zero_dev_frac:.2f} "
                f"spread={self.ref_score_spread:.3f})"
                f"{tail}")


def detection_drift(ref_dets, alt_dets, match_px: float = 8.0) -> DriftStats:
    """Compare two lists of per-image Detections (same images, two modes).

    Matching is one-to-one (greedy, closest pairs first): a duplicated alt
    box cannot claim the same ref box twice and a dropped ref box lowers
    ``set_agreement`` — exactly the NMS-level failures this metric exists to
    surface."""
    n_ref = n_alt = n_match = n_ref_sat = 0
    box_devs: list[float] = []
    score_devs: list[float] = []
    ref_scores: list[np.ndarray] = []
    for a, b in zip(ref_dets, alt_dets):
        n_ref += len(a)
        n_alt += len(b)
        if len(a):
            n_ref_sat += int(np.sum(a.obj * a.cls_score >= 0.9999))
            ref_scores.append(np.asarray(a.obj * a.cls_score))
        if not len(a) or not len(b):
            continue
        d = np.abs(b.boxes[:, None, :] - a.boxes[None, :, :]).max(-1)  # (B, A)
        sa = a.obj * a.cls_score
        sb = b.obj * b.cls_score
        cand = np.argwhere(d <= match_px)
        order = np.argsort(d[cand[:, 0], cand[:, 1]], kind="stable")
        used_b = np.zeros(len(b), bool)
        used_a = np.zeros(len(a), bool)
        for bi, ai in cand[order]:
            if used_b[bi] or used_a[ai]:
                continue
            used_b[bi] = used_a[ai] = True
            n_match += 1
            box_devs.append(float(d[bi, ai]))
            score_devs.append(float(abs(sb[bi] - sa[ai])))
    denom = max(n_ref, n_alt, 1)
    return DriftStats(
        images=len(ref_dets),
        ref_dets=n_ref,
        alt_dets=n_alt,
        set_agreement=n_match / denom,
        box_mean_px=float(np.mean(box_devs)) if box_devs else 0.0,
        box_p99_px=float(np.quantile(box_devs, 0.99)) if box_devs else 0.0,
        score_p99=float(np.quantile(score_devs, 0.99)) if score_devs else 0.0,
        ref_sat_frac=n_ref_sat / max(n_ref, 1),
        zero_dev_frac=(float(np.mean(np.asarray(box_devs) == 0.0))
                       if box_devs else 0.0),
        ref_score_spread=(float(np.diff(np.percentile(
            np.concatenate(ref_scores), [5, 95]))[0])
            if ref_scores else 1.0),
    )


def measure_mode_drift(det_ref, det_alt, images, size: int = 416,
                       conf: float = 0.5, iou: float = 0.4,
                       match_px: float = 8.0) -> DriftStats:
    """Run both detectors over ``images`` (list of HWC uint8) and compare."""
    ref = [det_ref.detect(img, size=size, conf=conf, iou=iou) for img in images]
    alt = [det_alt.detect(img, size=size, conf=conf, iou=iou) for img in images]
    return detection_drift(ref, alt, match_px=match_px)

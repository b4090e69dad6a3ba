"""A whole run on the CPU with the timed path broken underneath: each fault
a detection cell can have makes ``correct`` false, and the sound path keeps
it true.  (A one-chip cell has no exchange between chips to leave out.)"""

import pytest
from bench_cells import run, small_cell


@pytest.fixture(scope="module")
def cell():
    # conf 0.22: at this size enough candidates overlap for NMS to drop some
    return small_cell("yolov3-416.bf16-b128", 160, 240, 320, conf=0.22)


def _stale(call):
    """A step that returns its state unchanged: the first result, always."""
    first = []

    def wrapped(x):
        res = call(x)
        if not first:
            first.append(res)
        return first[0]
    return wrapped


def _half(call):
    """Half of the batch left out: the second half's results empty."""
    def wrapped(x):
        res = call(x)
        n = x.shape[0] // 2
        obj, valid = res.obj.clone(), res.valid.clone()
        obj[n:], valid[n:] = 0.0, False
        return res._replace(obj=obj, valid=valid)
    return wrapped


def _altered_box(call):
    """An answer altered where it is produced: the boxes of one frame's
    detections moved by a tenth of the frame."""
    def wrapped(x):
        res = call(x)
        boxes = res.boxes.clone()
        boxes[0] += 0.1 * x.shape[2]
        return res._replace(boxes=boxes)
    return wrapped


def _altered_class(call):
    """An answer altered where it is produced: one frame's classes moved by
    one."""
    def wrapped(x):
        res = call(x)
        cls = res.cls_id.clone()
        cls[0] = (cls[0] + 1) % 80
        return res._replace(cls_id=cls)
    return wrapped


def _keep_all(call):
    """NMS left out: every candidate kept."""
    def wrapped(x):
        res = call(x)
        return res._replace(valid=res.obj > 0.3)
    return wrapped


def test_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert list(res)[-1] == "checks"
    assert {m for m in res["metrics"]} == {"img_per_s", "batch_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", [_stale, _half, _altered_box, _altered_class, _keep_all],
                         ids=lambda f: f.__name__.strip("_"))
def test_fault_makes_the_run_incorrect(cell, fault):
    res = run(cell, wrap_call=fault)
    assert not res["correct"], res["checks"]

"""Median host milliseconds of a ``Detector.raw_result`` call, from the call to
its return, with no synchronize: the API and pipeline layer's dispatch cost.
Batches inside the profiled segment are left out."""

import statistics


def read(run):
    return statistics.median(run.enqueue_s) * 1e3 if run.enqueue_s else None

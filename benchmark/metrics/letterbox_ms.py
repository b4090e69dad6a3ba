"""Device ms a step of the letterbox group (the BGR flip and the bilinear
resize of ``ops/preprocess.py: letterbox_batch``)."""

from benchmark.trace import per_step_ms


def read(run):
    return per_step_ms(run.trace, lambda g: g == "letterbox")

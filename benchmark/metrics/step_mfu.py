"""Share (%) of the chip's peak at the model's precision that the whole step
reaches: the model's conv operations (2 MACs) a batch over the traced step
time (the segment's device window over its steps), at 989 TFLOP/s in bf16."""

from benchmark import roofline


def read(run):
    t = run.trace
    p = roofline.peaks(run.card)
    if t is None or not t.steps or t.window_s <= 0 or not p:
        return None
    step_s = t.window_s / t.steps
    return 100.0 * roofline.flops(run.work) / step_s / p["ops_per_s"][run.precision]

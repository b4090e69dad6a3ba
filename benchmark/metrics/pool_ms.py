"""Device ms a step of the maxpool group (``models/darknet.py: _maxpool``)."""

from benchmark.trace import per_step_ms


def read(run):
    return per_step_ms(run.trace, lambda g: g == "maxpool (SPP, the ladder)")

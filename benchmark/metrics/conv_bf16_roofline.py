"""Share (%) of the fp convs' device time a step that their roofline bounds
need: the sum over the model's convs of max(2 MACs / peak ops, bytes / peak
bandwidth) at the cell's batch and precision (``roofline.py``), over
``conv_bf16_ms``."""

from benchmark import roofline
from benchmark.trace import conv_group, per_step_ms


def read(run):
    ms = per_step_ms(run.trace, conv_group)
    bound = roofline.conv_bound_s(run.work, run.card, run.precision)
    if ms is None or bound is None:
        return None
    return 100.0 * bound * 1e3 / ms

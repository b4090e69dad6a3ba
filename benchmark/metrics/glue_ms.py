"""Device ms a step of the forward's glue: copies and casts, concats,
upsamples and adds."""

from benchmark.trace import per_step_ms

GLUE = ("copies and casts", "concat", "upsample", "adds (bias, shortcut)")


def read(run):
    return per_step_ms(run.trace, lambda g: g in GLUE)

"""Device ms a step of decode, top-K and NMS: K1, the top-K sort and K2."""

from benchmark.trace import per_step_ms

POST = ("K1 decode+score", "top-K sort", "K2 NMS keep")


def read(run):
    return per_step_ms(run.trace, lambda g: g in POST)

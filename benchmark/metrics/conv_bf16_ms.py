"""Device ms a step of the fp convs: every K5 group and any cuDNN / cuBLAS
conv group."""

from benchmark.trace import conv_group, per_step_ms


def read(run):
    return per_step_ms(run.trace, conv_group)

"""The 95th percentile, over every batch completed in the window, of the host
time from the start of its ``raw_result`` call to its results on the host."""

import numpy as np


def read(run):
    return float(np.percentile([(d.done - d.start) * 1e3 for d in run.window], 95))

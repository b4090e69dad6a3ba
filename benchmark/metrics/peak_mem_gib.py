"""Peak device memory allocated over the window (``max_memory_allocated``
after a reset at its start), GiB."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.peak_window_bytes else None

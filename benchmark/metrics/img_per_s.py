"""Images whose results reached the host in the window, over the window's
seconds (host clock, from the completion that opens it to the last one in it)."""


def read(run):
    return run.batch * len(run.window) / (run.t_end - run.t0)

"""idle_share.fold: one minus the device's busy time (the union of its
operations' intervals) over the traced window, from the profiler's trace."""


def read(run):
    return run.idle_share()

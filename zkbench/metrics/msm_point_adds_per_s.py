"""msm_point_adds_per_s: nominal point-adds of the MSMs completed in the
window (n * ceil(256 / 16) each, whatever window the program picks), over
the whole window."""


def read(run):
    return run.completed * run.work / run.window_s if run.completed else None

"""fold_step_s: the whole window over the folding steps completed in it."""


def read(run):
    return run.window_s / run.completed if run.completed else None

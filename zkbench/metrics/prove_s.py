"""prove_s: the whole window over the proofs completed in it."""


def read(run):
    return run.window_s / run.completed if run.completed else None

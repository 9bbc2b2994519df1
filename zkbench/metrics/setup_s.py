"""setup_s: process start to the first timed request (imports, kernel load,
inputs, the program's set-up, warm-up), on the host clock."""


def read(run):
    return run.setup_s

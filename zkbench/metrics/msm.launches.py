"""msm.launches: device kernels per MSM in the trace (memory copies and sets
not counted)."""


def read(run):
    d = run.device
    return d["kernels"] / run.traced_requests if d and run.traced_requests else None

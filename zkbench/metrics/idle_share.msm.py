"""idle_share.msm: one minus the device's busy time (the union of its
operations' intervals) over the traced window, from the profiler's trace.
Its spans label the idle gaps of the run's breakdown by the layer the host
was in."""

SPANS = [
    ("kogarashi_tpu_torch.ops.msm:msm", "ops/msm.py msm", False),
    ("kogarashi_tpu_torch.ops.msm:signed_digits", "msm signed_digits", False),
    ("kogarashi_tpu_torch.ops.msm:_windows", "msm bucket sums", False),
    ("kogarashi_tpu_torch.ops.msm:inclusive_prefix", "msm inclusive_prefix", False),
    ("kogarashi_tpu_torch.ops.msm:reduce_points", "msm reduce_points", False),
    ("kogarashi_tpu_torch.ops.msm:window_combine", "msm window_combine", False),
]


def read(run):
    return run.idle_share()

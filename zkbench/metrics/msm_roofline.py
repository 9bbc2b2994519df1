"""msm_roofline: the least time the card could take for one MSM's nominal work
(`zkbench/roofline.py`) over the device's busy time per traced MSM, in %."""

from zkbench.roofline import msm_bound_s


def read(run):
    d = run.device
    if not d or not run.traced_requests or d["busy_s"] <= 0:
        return None
    return 100 * msm_bound_s(run.work, run.io_bytes) / (d["busy_s"] / run.traced_requests)

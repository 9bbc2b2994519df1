"""Trace one Nova folding step on one GPU.

    python3 -m kogarashi_tpu_torch.profile_ivc

PublicParams.setup with random.Random(99) (benches/ivc_chain.py's seed),
Ivc, the base step and two folding steps (warm-up, wall seconds each), then
one folding step under torch.profiler: kernels launched, device busy time
(the union of the kernel intervals), the share of it in K1-K4, the idle
share of the traced window and the kernels that took the most device time
(`profile_prove.trace_summary`). The card (nvidia-smi name, power limit) is
printed on its own line, and one JSON object with every number as the last
line. Needs a CUDA device.
"""

from __future__ import annotations

import json
import random
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from .nova import ExampleFunction, Ivc, PublicParams
from .ops import _build
from .profile_lanes import card
from .profile_prove import trace_summary


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_ivc: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = card()
    print(name, flush=True)
    _build.lib()
    t0 = time.perf_counter()
    pp = PublicParams.setup(ExampleFunction, ExampleFunction, random.Random(99), device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ivc = Ivc(pp, z0_primary=[0], z0_secondary=[0])
    steps = []
    for _ in range(3):
        t0 = time.perf_counter()
        ivc.prove_step()
        torch.cuda.synchronize()
        steps.append(time.perf_counter() - t0)
    print(f"[ivc] setup {setup_s:.3f} s; warm-up steps {[round(t, 4) for t in steps]} s ({name})", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("step"):
            ivc.prove_step()
            torch.cuda.synchronize()
    step = trace_summary(prof, "step")
    print(f"[trace] one folding step: {step} ({name})", flush=True)
    print(name, flush=True)
    print(json.dumps(dict(card=name, setup_s=setup_s, steps_s=steps, trace_step=step)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Profile a warm Groth16 prove of SquareChainCircuit(2^20) on one GPU.

    python3 -m kogarashi_tpu_torch.profile_prove

Setup runs once, then:
  prove  three warm proves without stage logging (no extra synchronisation),
         wall seconds; then one with stage logging, seconds per stage (one
         stage per MSM, each including the host decode of its result)
  msm    each of the prove's five MSMs again, alone, on the bases and scalars
         the prove gave it: wall seconds to the device's end, device seconds
         between CUDA events, and the host decode
  trace  one prove, then its h MSM alone, under torch.profiler: kernels
         launched, device busy time (the union of the kernel intervals), the
         share of it in K1-K4, and the idle share of the traced window
The card (nvidia-smi name, power limit) is printed on its own line, and one
JSON object with every number as the last line. Needs a CUDA device.
"""

from __future__ import annotations

import json
import logging
import random
import statistics
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from .curves import decode_points
from .groth16 import SquareChainCircuit, setup
from .groth16 import prover as prover_mod
from .ops import _build
from .ops.msm import msm

LOG2_CONSTRAINTS = 20
EC_KERNELS = ("scan_mixed_kernel", "scan_proj_kernel", "scan_proj_group_kernel", "padd_kernel",
              "pdouble_kernel", "pdouble_group_kernel")


def trace_summary(prof, window: str) -> dict:
    """Device busy time of the kernels in prof, against the wall window of
    the record_function range named `window` (widened to the kernels' ends)."""
    events = prof.events()
    span = next(e for e in events if e.name == window and e.device_type == DeviceType.CPU)
    # the range itself also shows on the device timeline as an annotation
    kern = [e for e in events if e.device_type == DeviceType.CUDA and e.name != window]
    iv = sorted((e.time_range.start, e.time_range.end) for e in kern)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    lo = min([span.time_range.start] + [s for s, _ in iv])
    hi = max([span.time_range.end] + [e for _, e in iv])
    by_name = defaultdict(float)
    for e in kern:
        by_name[e.name] += e.time_range.elapsed_us()
    ec_us = sum(t for n, t in by_name.items() if any(k in n for k in EC_KERNELS))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(kernels=len(kern), wall_ms=(hi - lo) / 1e3, busy_ms=busy / 1e3,
                idle_share=1 - busy / (hi - lo), ec_kernels_ms=ec_us / 1e3,
                ec_share_of_busy=ec_us / busy if busy else 0.0,
                top=[(n[:70], round(t / 1e3, 3)) for n, t in top])


def capture_msm_inputs(prover, circuit):
    """Run one prove and keep the (curve, query, scalars) of each MSM it makes."""
    calls, real = [], prover_mod.msm

    def recording(curve, x, y, inf, scalars):
        calls.append((curve, (x, y, inf), scalars))
        return real(curve, x, y, inf, scalars)

    prover_mod.msm = recording
    try:
        prover.create_proof(circuit, random.Random(12))
    finally:
        prover_mod.msm = real
    return calls


def time_msm(curve, query, scalars, reps: int = 3) -> dict:
    wall, dec = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = msm(curve, *query, scalars)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        decode_points(curve, out)
        wall.append(t1 - t0)
        dec.append(time.perf_counter() - t1)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        msm(curve, *query, scalars)
    end.record()
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / reps
    return dict(n=int(query[0].shape[1]), wall_s=statistics.median(wall),
                device_s=dev_ms / 1e3, decode_s=statistics.median(dec))


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_prove: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    _build.lib()
    stage_log = logging.getLogger("kogarashi_tpu_torch.groth16.prover")
    logging.basicConfig(format="[prove] %(message)s", stream=sys.stdout)
    circuit = SquareChainCircuit(1 << LOG2_CONSTRAINTS)
    prover, _ = setup(circuit, random.Random(11), device=dev)
    calls = capture_msm_inputs(prover, circuit)  # also the warm-up prove

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prover.create_proof(circuit, random.Random(12))
        walls.append(time.perf_counter() - t0)
    print(f"[prove] warm, no stage logging: {walls}", flush=True)
    stage_log.setLevel(logging.INFO)
    prover.create_proof(circuit, random.Random(12))
    stage_log.setLevel(logging.WARNING)

    names = ["h (G1)", "l (G1)", "a (G1)", "b (G1)", "b (G2)"]
    msms = {}
    for name, (curve, query, scalars) in zip(names, calls):
        msms[name] = time_msm(curve, query, scalars)
        print(f"[msm] {name}: {msms[name]}", flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("prove"):
            prover.create_proof(circuit, random.Random(12))
    prove_trace = trace_summary(prof, "prove")
    print(f"[trace] prove: {prove_trace}", flush=True)
    curve, query, scalars = calls[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("msm"):
            msm(curve, *query, scalars)
            torch.cuda.synchronize()
    msm_trace = trace_summary(prof, "msm")
    print(f"[trace] h MSM alone: {msm_trace}", flush=True)

    print(card, flush=True)
    print(json.dumps(dict(card=card, prove_wall_s=walls, msm=msms, trace_prove=prove_trace,
                          trace_h_msm=msm_trace)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Headline benchmark of the port: BN254 G1 MSM throughput on one card.

    python -m kogarashi_tpu_torch.bench [--device cpu]

Counterpart of the repo's `bench.py` (which times the JAX package): the same
workload, accounting and output, on the port's `ops/msm.py::msm` (K1-K4).
Prints ONE JSON line on stdout, {"metric", "value", "unit", "vs_baseline"}:
point-adds = n * ceil(256/c) bucket-accumulation additions of standard
Pippenger, `value` = point-adds / the best rep's seconds, and `vs_baseline`
= value / 1e8. The 1e8 point-adds/s per chip is `BASELINE.md`'s target, a
goal set for the reference, not a measurement on any device. One `#` line
on stderr gives c, the windows, the best and the median rep, every rep, the
first call's seconds (the kernels' build and the allocator's warm-up),
`oracle=PASS` and the card's name and power limit.

Workload (`bench.py:55-78`): 64 distinct bases k * g, k from
random.Random(0xBE7C4) below r, tiled to n = 2^log_n points (repeated
bases are the adversarial case for the sorted-scan bucket accumulation);
scalars from np.random.default_rng(1) as (16, n) 16-bit limbs, the top limb
masked below 2^14, so every scalar is below 2^254 < r. The oracle sums each
base's scalars (its effective scalar) and multiplies once per base.

Measurement: each rep starts after a device synchronisation and copies the
result to the host inside the timed window; every result (the first call's
and each rep's) is held to the oracle, so a wrong kernel cannot "win".

Env overrides, as `bench.py`: KOGARASHI_BENCH_LOG_N (default 20),
KOGARASHI_BENCH_C (16), KOGARASHI_BENCH_REPS (3).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import time

import numpy as np
import torch

from .curves import G1, Curve, decode_points, prepare_points
from .devices import describe, resolve, synchronize
from .fields.spec import FR
from .ops.msm import msm

N_BASES = 64  # distinct bases, tiled (`bench.py:58`)
SEED_BASES = 0xBE7C4  # random.Random seed of the bases' discrete logs (`bench.py:60`)
SEED_SCALARS = 1  # np.random.default_rng seed of the scalars (`bench.py:68`)
BASELINE = 1e8  # BASELINE.md's target, point-adds/s per chip


def oracle(curve: Curve, dk, sc: np.ndarray):
    """sum_i k_i P_i for P_i = dk[i mod len(dk)] * g and the (16, n) limbs
    `sc`: each base's effective scalar (the sum of its scalars, by numpy per
    limb) times its discrete log, once per base."""
    nd, n = len(dk), sc.shape[1]
    sums = sc.astype(np.int64).reshape(16, n // nd, nd).sum(axis=1)  # (16, nd); each < 2^16 n / nd
    eff = [sum(int(sums[limb, b]) << (16 * limb) for limb in range(16)) for b in range(nd)]
    r = FR.p
    return (sum((e % r) * k for e, k in zip(eff, dk)) % r) * curve.pyref_spec.generator


def workload(log_n: int, device=None, curve: Curve = G1, seed_bases: int = SEED_BASES,
             seed_scalars: int = SEED_SCALARS):
    """`bench.py`'s inputs on `device` (None: the card): (x, y, inf, scalars,
    expected). The 64 bases are encoded once and tiled on the device;
    scalars are (16, n) int32 limbs; `expected` is the pyref point."""
    device = resolve(device)
    n = 1 << log_n
    if n % N_BASES:
        raise ValueError(f"2^{log_n} points do not tile {N_BASES} bases")
    rng = random.Random(seed_bases)
    dk = [rng.randrange(1, FR.p) for _ in range(N_BASES)]
    g = curve.pyref_spec.generator
    x64, y64, inf64 = prepare_points(curve, [k * g for k in dk], device)
    tiles = n // N_BASES
    sc = np.random.default_rng(seed_scalars).integers(0, 1 << 16, size=(16, n), dtype=np.uint32)
    sc[15] &= 0x3FFF  # < 2^254 < r
    scalars = torch.from_numpy(sc.astype(np.int32)).to(device)
    return x64.repeat(1, tiles), y64.repeat(1, tiles), inf64.repeat(tiles), scalars, oracle(curve, dk, sc)


def run(log_n=None, c=None, reps=None, device=None) -> tuple[dict, dict]:
    """Time the 2^log_n G1 MSM; arguments left None read the environment's
    KOGARASHI_BENCH_* overrides (defaults 20, 16, 3). Returns (result,
    info): result is `bench.py`'s JSON object; info holds n, c, windows,
    best, median, times (s, each rep's) and first_s."""
    env = os.environ.get
    log_n = int(env("KOGARASHI_BENCH_LOG_N", "20")) if log_n is None else log_n
    c = int(env("KOGARASHI_BENCH_C", "16")) if c is None else c
    reps = int(env("KOGARASHI_BENCH_REPS", "3")) if reps is None else reps
    device = resolve(device)
    x, y, inf, scalars, expected = workload(log_n, device)
    n, windows = 1 << log_n, -(-256 // c)

    def call():
        synchronize(device)
        t0 = time.perf_counter()
        host = [o.cpu() for o in msm(G1, x, y, inf, scalars, c=c)]  # host copy inside the timed window
        seconds = time.perf_counter() - t0
        if decode_points(G1, host)[0] != expected:
            raise AssertionError(f"MSM 2^{log_n} (c = {c}) does not match the host oracle")
        return seconds

    first = call()
    times = [call() for _ in range(reps)]
    best = min(times)
    value = n * windows / best
    result = {"metric": f"bn254_g1_msm_point_adds_per_s_2^{log_n}", "value": value,
              "unit": "point-adds/s/chip", "vs_baseline": value / BASELINE}
    info = dict(n=n, c=c, windows=windows, best=best, median=statistics.median(times), times=times,
                first_s=first)
    return result, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve(args.device)
    result, info = run(device=device)
    print(json.dumps(result), flush=True)
    print(f"# n=2^{info['n'].bit_length() - 1} c={info['c']} windows={info['windows']} best={info['best']:.6f}s "
          f"median={info['median']:.6f}s times={[round(t, 6) for t in info['times']]} "
          f"first(build+warm-up)={info['first_s']:.3f}s oracle=PASS device={describe(device)}",
          file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

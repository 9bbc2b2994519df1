"""Time K2 (scan_proj) and K4 (map_pdouble) at every built lane group on one GPU.

    python3 -m kogarashi_tpu_torch.profile_lanes [--baseline DIR]

For G1 and G2 at a 2^20-point MSM with c = 16, and Grumpkin at the MSM of
one Nova secondary commit (78982 points, c = 16): K2 at each shape the MSM
gives it (`msm.scan_proj_launches`), K4 with t = 16 at 1 to 2^16 lanes; each
at every group size built for it (`ops.ec.groups`), checked exactly against
the plain version and timed on the device (`ec.device_ms`, mean of 20 calls
in a row), beside the group `ec.lane_group` picks. K2's time summed over one
MSM's 20 launches at the groups the rule picks is logged per curve, and the
device time of a c = 16 MSM's window combine (`msm.window_combine`, 15 x K4
t = 16 + K3 at one lane; mean of 3). K1 at the MSM's scan shape and K3 at
its width are timed too. Then the latency of one dependent Montgomery
multiply (csrc/imad_probe.cu, inline and as G2's call) and of an empty
launch.

--baseline DIR: also K1, K2 and K3 at the same shapes, K4 at 1 and 2^16
lanes and the window combine through the package of another checkout in DIR
(its own build, its own default launch; for example the parent commit
unpacked with `git archive`), on the same inputs, exactly against this
package's plain versions (the combine against this package's), and K2's
summed time against this package's; curves the baseline lacks are skipped
for it. The baseline build's registers and SASS counts are printed. The
card (nvidia-smi name, power limit) is printed on its own line, and one JSON
object with every number as the last line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .curves import G1, G2, GRUMPKIN, to_affine
from .ops import ec
from .ops.fixed_base import fixed_base_mul
from .ops.msm import scan_depth, scan_proj_launches, window_combine

K4_LANES = (1, 4, 16, 64, 256, 1024, 4096, 1 << 16)
# (curve, seed, MSM points): the Groth16 MSMs, and one Nova secondary commit
SWEEP = ((G1, 1, 1 << 20), (G2, 2, 1 << 20), (GRUMPKIN, 3, 78982))
# a combine is about 80 launches; 20 in a row overflow the device's queue of
# pending launches, so the host blocks behind device_ms's spin
COMBINE_REPS = 3


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _points(curve, m: int, seed: int, dev):
    sc = np.random.default_rng(seed).integers(0, 1 << 16, size=(16, m), dtype=np.uint32)
    sc[15] &= 0x3FFF
    sc[0] |= 1
    return fixed_base_mul(curve, torch.from_numpy(sc.astype(np.int32)).to(dev))


def _load_package(root: Path):
    """The kogarashi_tpu_torch package under `root`, imported as
    `baseline_kt` (its imports are relative, so it uses its own modules)."""
    pkg = root / "kogarashi_tpu_torch"
    spec = importlib.util.spec_from_file_location("baseline_kt", pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_kt"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("baseline_kt.ops.ec"), importlib.import_module("baseline_kt.curves"),
            importlib.import_module("baseline_kt.ops._build"))


def _exact(got, want) -> bool:
    return all(torch.equal(x, y) for x, y in zip(got, want))


def _combine(ec_mod, curve, G, c: int):
    """The window combine as `msm.window_combine` runs it, through the
    kernels of `ec_mod` (a baseline package's, which may predate it)."""
    acc = tuple(g[:, -1].contiguous() for g in G)
    for w in range(G[0].shape[1] - 2, -1, -1):
        acc = ec_mod.map_pdouble(curve, acc, times=c)
        acc = ec_mod.map_padd(curve, acc, tuple(g[:, w].contiguous() for g in G))
    return acc


def sweep(dev, log, baseline=None) -> dict:
    """Every built g at K2's and K4's shapes, K1 and K3 at the MSM's; with
    `baseline` = (ec, curves, _build) of another package, its default launch
    at the same shapes as well."""
    out = {"scan_mixed": [], "map_padd": [], "scan_proj": [], "map_pdouble": [],
           "window_combine": [], "msm_sum_ms": {}}
    for curve, seed, n in SWEEP:
        rows = curve.rows
        k2 = scan_proj_launches(n, 16)
        old = getattr(baseline[1], curve.name.upper(), None) if baseline else None
        pts = _points(curve, max(n, max(L * C for (L, C), _ in k2)), seed, dev)
        L1 = scan_depth(16 * n)
        C1 = 16 * (-(-n // L1))
        aff = to_affine(curve, pts)
        gen = torch.Generator(device="cpu").manual_seed(seed)
        m = pts[0].shape[1]
        perm = torch.cat([torch.randperm(m, generator=gen) for _ in range(-(-L1 * C1 // m))])[: L1 * C1]
        k1_in = tuple(t[:, perm.to(dev)].reshape(rows, L1, C1).contiguous() for t in aff[:2])
        k3_in = (tuple(t[:, :n].contiguous() for t in pts),
                 tuple(t[:, :n].roll(1, dims=1).contiguous() for t in pts))
        for kname, shape, args in (("scan_mixed", (rows, L1, C1), k1_in), ("map_padd", (rows, n), k3_in)):
            want = getattr(ec, f"{kname}_plain")(curve, *args)
            if not _exact(getattr(ec, kname)(curve, *args), want):
                raise AssertionError(f"{kname}_{curve.name} {shape} differs")
            row = dict(curve=curve.name, shape=list(shape),
                       ms=ec.device_ms(lambda: getattr(ec, kname)(curve, *args), dev, 10))
            extra = ""
            if old is not None:
                if not _exact(getattr(baseline[0], kname)(old, *args), want):
                    raise AssertionError(f"baseline {kname}_{curve.name} {shape} differs")
                row["baseline_ms"] = ec.device_ms(lambda: getattr(baseline[0], kname)(old, *args), dev, 10)
                extra = f"; baseline {row['baseline_ms']:.4f} ms"
            out[kname].append(row)
            log(f"{kname}_{curve.name} {shape}: {row['ms']:.4f} ms{extra}")
        del aff, k1_in, k3_in, want
        sums = {"rule": 0.0, "baseline": 0.0}
        for (L, C), launches in k2:
            a = tuple(t[:, : L * C].reshape(rows, L, C).contiguous() for t in pts)
            want = ec.scan_proj_plain(curve, *a)
            row = dict(curve=curve.name, shape=[rows, L, C], launches=launches,
                       chosen=ec.lane_group("scan_proj", curve, C), ms={})
            for g in ec.groups("scan_proj", curve):
                if not _exact(ec.scan_proj(curve, *a, group=g), want):
                    raise AssertionError(f"scan_proj_{curve.name} {(rows, L, C)} g={g} differs")
                row["ms"][g] = ec.device_ms(lambda: ec.scan_proj(curve, *a, group=g), dev)
            sums["rule"] += launches * row["ms"][row["chosen"]]
            extra = ""
            if old is not None:
                if not _exact(baseline[0].scan_proj(old, *a), want):
                    raise AssertionError(f"baseline scan_proj_{curve.name} {(rows, L, C)} differs")
                row["baseline_ms"] = ec.device_ms(lambda: baseline[0].scan_proj(old, *a), dev)
                sums["baseline"] += launches * row["baseline_ms"]
                extra = f"; baseline {row['baseline_ms']:.4f} ms"
            out["scan_proj"].append(row)
            log(f"scan_proj_{curve.name} {(rows, L, C)} x{launches}: " + ", ".join(
                f"g={g} {ms:.4f}" for g, ms in row["ms"].items()) + f" ms; rule g={row['chosen']}{extra}")
        out["msm_sum_ms"][curve.name] = sums
        log(f"scan_proj_{curve.name} over one {n}-point MSM's {sum(k for _, k in k2)} launches: "
            f"{sums['rule']:.4f} ms at the "
            f"rule's g" + (f", baseline {sums['baseline']:.4f} ms ({sums['baseline'] / sums['rule']:.2f}x)"
                           if old is not None else ""))
        for C in K4_LANES:
            p = tuple(t[:, :C].contiguous() for t in pts)
            want = ec.map_pdouble_plain(curve, p, times=16)
            row = dict(curve=curve.name, shape=[rows, C], times=16,
                       chosen=ec.lane_group("map_pdouble", curve, C), ms={})
            for g in ec.groups("map_pdouble", curve):
                if not _exact(ec.map_pdouble(curve, p, times=16, group=g), want):
                    raise AssertionError(f"map_pdouble_{curve.name} {(rows, C)} g={g} differs")
                row["ms"][g] = ec.device_ms(lambda: ec.map_pdouble(curve, p, times=16, group=g), dev)
            extra = ""
            if old is not None and C in (1, 1 << 16):
                if not _exact(baseline[0].map_pdouble(old, p, times=16), want):
                    raise AssertionError(f"baseline map_pdouble_{curve.name} {(rows, C)} differs")
                row["baseline_ms"] = ec.device_ms(lambda: baseline[0].map_pdouble(old, p, times=16), dev)
                extra = f"; baseline {row['baseline_ms']:.4f} ms"
            out["map_pdouble"].append(row)
            log(f"map_pdouble_{curve.name} {(rows, C)} t=16: " + ", ".join(
                f"g={g} {ms:.4f}" for g, ms in row["ms"].items()) + f" ms; rule g={row['chosen']}{extra}")
        # the window combine of a c = 16 MSM: 16 window sums, (rows, 16, 1)
        sums_w = tuple(t[:, :16].reshape(rows, 16, 1).contiguous() for t in pts)
        want = window_combine(curve, sums_w, 16)
        row = dict(curve=curve.name,
                   ms=ec.device_ms(lambda: window_combine(curve, sums_w, 16), dev, COMBINE_REPS))
        extra = ""
        if old is not None:
            if not _exact(_combine(baseline[0], old, sums_w, 16), want):
                raise AssertionError(f"baseline window combine {curve.name} differs")
            row["baseline_ms"] = ec.device_ms(lambda: _combine(baseline[0], old, sums_w, 16), dev,
                                              COMBINE_REPS)
            extra = f"; baseline {row['baseline_ms']:.4f} ms"
        out["window_combine"].append(row)
        log(f"window combine {curve.name} (15 x map_pdouble t=16 + map_padd at one lane): "
            f"{row['ms']:.4f} ms{extra}")
        del pts
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="root of another checkout to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_lanes: needs a CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    name = card()
    print(name, flush=True)

    def log(msg):
        print(f"[lanes] {msg} ({name})", flush=True)

    baseline = _load_package(args.baseline.resolve()) if args.baseline else None
    if baseline:
        baseline[2].lib()
        for line in baseline[2].ptxas_report() + [f"sass {x}" for x in baseline[2].sass_report()]:
            log(f"baseline build: {line}")
    rec = sweep(dev, log, baseline)
    rec["mul_latency_cycles"] = {"inline": ec.mul_latency_cycles(dev, False),
                                 "call": ec.mul_latency_cycles(dev, True)}
    rec["empty_launch_ms"] = ec.empty_launch_ms(dev)
    log(f"dependent multiply: {rec['mul_latency_cycles']['inline']:.1f} cycles inline, "
        f"{rec['mul_latency_cycles']['call']:.1f} as a call; empty launch {rec['empty_launch_ms']:.5f} ms")
    rec["card"] = name
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

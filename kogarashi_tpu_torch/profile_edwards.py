"""Time E1 (`ed_scalar_mul`), E2 (`ed_map_add`) and E3 (`ed_map_double`) at every candidate lane group on one GPU.

    python3 -m kogarashi_tpu_torch.profile_edwards [--baseline DIR]

Builds csrc/edwards.cu once more with every group size of CANDIDATE_G for
E1-E3 (-DKT_ED_GROUPS; its ptxas registers and spills printed), then times
E1 at E1_LANES, E2 (p - q) at E2_LANES and E3 (t = 3) at E3_LANES lanes at
each g through that build, and through the package at the g its rule picks
(`ops/ec.py` LANE_GROUPS, which comes from these times), each checked
exactly against the plain version (E1's inputs are the 2048-lane signature
path's tiled, so one plain ladder checks every shape) and timed on the
device (`ec.device_ms`).

--baseline DIR: also E1-E3 at the same shapes through the package of another
checkout in DIR (its own build and its own default launch; for example the
parent commit unpacked with `git archive`), on the same inputs, held to this
package's plain versions. The card (nvidia-smi name, power limit) is printed
on its own line, and one JSON object with every number as the last line.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import torch

from .curves.edwards import JUBJUB
from .fields import mont
from .fields.spec import BLS_FR, ints_to_limbs16
from .ops import _build, ec
from .ops import edwards as E
from .profile_lanes import _load_package, card

CANDIDATE_G = (1, 2, 4, 8, 16)
E1_BASE = 2048  # the 1024-signature path's lanes; the other shapes tile it
E1_LANES = (2048, 4096, 6144, 8192, 12288, 16384, 24576, 32768, 65536)
E2_LANES = (1024, 2048, 4096, 8192, 16384, 1 << 16)
E3_LANES = (1024, 2048, 4096, 8192, 12288, 16384, 24576, 32768, 1 << 16)


def jubjub_lanes(n: int, seed: int, dev):
    """n Jubjub points (one in eight the identity, the rest random) with a
    random Z each, and n scalars: the edge scalars (0, 1, order - 1, order,
    2^256 - 1, p - 1), then random 256-bit values."""
    rng = random.Random(seed)
    g = JUBJUB.pyref_spec.generator.to_extended()
    base = [(rng.randrange(1, JUBJUB.order) * g).to_affine() for _ in range(63)] + [
        JUBJUB.pyref_spec.identity_affine()]
    p = JUBJUB.encode_points([base[i % 64] for i in range(n)], dev)
    z = torch.from_numpy(BLS_FR.encode([rng.randrange(1, BLS_FR.p) for _ in range(n)])).to(dev)
    p = tuple(mont.mul(c, z, spec=BLS_FR) for c in p)
    ks = [0, 1, JUBJUB.order - 1, JUBJUB.order, (1 << 256) - 1, BLS_FR.p - 1]
    ks += [rng.randrange(1 << 256) for _ in range(n - len(ks))]
    return p, torch.from_numpy(ints_to_limbs16(ks)).to(dev)


def build_candidates():
    """csrc/edwards.cu built with every group size of CANDIDATE_G for E1-E3,
    loaded, and its ptxas lines."""
    src = _build.CSRC / "edwards.cu"
    h = hashlib.sha256(_build.ARCH.encode())
    for f in (src, _build.CSRC / "field.cuh", _build.CSRC / "lane_group.cuh"):
        h.update(f.read_bytes())
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    lib = _build.BUILD / f"libkt_ed_candidates_{h.hexdigest()[:16]}.so"
    tmp = lib.with_name(f".{lib.name}.{os.getpid()}")
    mask = hex(sum(1 << g for g in CANDIDATE_G))
    res = subprocess.run(
        [_build._cuda_tool("nvcc"), "-gencode", _build.ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
         "-Xptxas", "-v", f"-DKT_ED_GROUPS={mask}", "-shared", "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc with every candidate group failed ({res.returncode}):\n{res.stdout[-8000:]}")
    os.replace(tmp, lib)
    handle = ctypes.CDLL(str(lib))
    for fmt, args in _build._ED_SIGNATURES.items():
        fn = getattr(handle, fmt.format(c="jubjub"))
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return handle, _build.parse_ptxas(res.stdout)


def _out4(n: int, dev):
    return tuple(torch.empty((8, n), dtype=torch.int32, device=dev) for _ in range(4))


def _exact(got, want) -> bool:
    return all(torch.equal(x, y) for x, y in zip(got, want))


def _time(runs: dict, want, dev, reps: int, what: str) -> dict:
    """{name: device ms} of each run, each first held exactly to `want`."""
    ms = {}
    for name, fn in runs.items():
        if not _exact(fn(), want):
            raise AssertionError(f"{what} {name} differs from the plain version")
        ms[name] = ec.device_ms(fn, dev, reps)
    return ms


def sweep(dev, log, baseline=None) -> dict:
    """E1, E2 and E3 at their shapes: every candidate g through the
    candidates' build, the package at its rule's g, and with `baseline` =
    (ops.edwards, curves.edwards) of another package its default launch."""
    lib, lines = build_candidates()
    for line in lines:
        log(f"candidates' build: {line}")
    stream = torch.cuda.current_stream().cuda_stream
    rec = {"candidates_build": lines, "ed_scalar_mul": [], "ed_map_add": [], "ed_map_double": []}
    old = baseline[1].JUBJUB if baseline else None

    p, k = jubjub_lanes(E1_BASE, 11, dev)
    want = E.scalar_mul_plain(JUBJUB, p, k)
    for n in E1_LANES:
        t = n // E1_BASE
        pp, kk = tuple(c.repeat(1, t) for c in p), k.repeat(1, t)

        def cand(g, pp=pp, kk=kk, n=n):
            out = _out4(n, dev)
            _build.check(lib.kt_ed_scalar_mul_jubjub(*[c.data_ptr() for c in pp], n, kk.data_ptr(),
                                                     *[c.data_ptr() for c in out], n, g, stream), f"E1 g={g}")
            return out

        runs = {f"g={g}": (lambda g=g: cand(g)) for g in CANDIDATE_G}
        rule = ec.lane_group("ed_scalar_mul", JUBJUB, n)
        runs[f"package g={rule}"] = lambda: E.scalar_mul(JUBJUB, pp, kk)
        if old is not None:
            runs["baseline"] = lambda: baseline[0].scalar_mul(old, pp, kk)
        ms = _time(runs, tuple(c.repeat(1, t) for c in want), dev, 5, f"ed_scalar_mul (8, {n})")
        rec["ed_scalar_mul"].append(dict(shape=[8, n], rule_g=rule, ms=ms))
        log(f"ed_scalar_mul (8, {n}): exact; " + ", ".join(f"{k_} {v:.4f}" for k_, v in ms.items()) + " ms")
    del p, k, want

    for n in E2_LANES:
        a, _ = jubjub_lanes(n, 12, dev)
        b = tuple(c.roll(1, dims=1).contiguous() for c in a)

        def cand(g, a=a, b=b, n=n):
            out = _out4(n, dev)
            _build.check(lib.kt_ed_map_add_jubjub(*[c.data_ptr() for c in (*a, *b, *out)], n, 1, g, stream),
                         f"E2 g={g}")
            return out

        runs = {f"g={g}": (lambda g=g: cand(g)) for g in CANDIDATE_G}
        rule = ec.lane_group("ed_map_add", JUBJUB, n)
        runs[f"package g={rule}"] = lambda: E.map_add(JUBJUB, a, b, neg=True)
        if old is not None:
            runs["baseline"] = lambda: baseline[0].map_add(old, a, b, neg=True)
        ms = _time(runs, E.map_add_plain(JUBJUB, a, b, neg=True), dev, 20, f"ed_map_add (8, {n})")
        rec["ed_map_add"].append(dict(shape=[8, n], rule_g=rule, ms=ms))
        log(f"ed_map_add (8, {n}) p - q: exact; " + ", ".join(f"{k_} {v:.5f}" for k_, v in ms.items()) + " ms")

    for n in E3_LANES:
        a, _ = jubjub_lanes(n, 13, dev)

        def cand(g, a=a, n=n):
            out = _out4(n, dev)
            _build.check(lib.kt_ed_map_double_jubjub(*[c.data_ptr() for c in (*a, *out)], n, 3, g, stream),
                         f"E3 g={g}")
            return out

        runs = {f"g={g}": (lambda g=g: cand(g)) for g in CANDIDATE_G}
        rule = ec.lane_group("ed_map_double", JUBJUB, n)
        runs[f"package g={rule}"] = lambda: E.map_double(JUBJUB, a, 3)
        if old is not None:
            runs["baseline"] = lambda: baseline[0].map_double(old, a, 3)
        ms = _time(runs, E.map_double_plain(JUBJUB, a, 3), dev, 20, f"ed_map_double (8, {n})")
        rec["ed_map_double"].append(dict(shape=[8, n], times=3, rule_g=rule, ms=ms))
        log(f"ed_map_double (8, {n}) t=3: exact; " + ", ".join(f"{k_} {v:.5f}" for k_, v in ms.items()) + " ms")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="root of another checkout to time beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_edwards: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    name = card()
    print(name, flush=True)

    def log(msg):
        print(f"[edwards] {msg} ({name})", flush=True)

    _build.lib()
    for line in _build.ptxas_report():
        if line.startswith("ed_"):
            log(f"package build: {line}")
    baseline = None
    if args.baseline:
        _, _, bbuild = _load_package(args.baseline.resolve())
        baseline = (importlib.import_module("baseline_kt.ops.edwards"),
                    importlib.import_module("baseline_kt.curves.edwards"))
        bbuild.lib()
        for line in bbuild.ptxas_report():
            if line.startswith("ed_"):
                log(f"baseline build: {line}")
    rec = sweep(dev, log, baseline)
    rec["card"] = name
    print(name, flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
